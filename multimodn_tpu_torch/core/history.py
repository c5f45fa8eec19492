"""Training history store, plotting, and CSV export (copy of
``multimodn_tpu/core/history.py``, which is numpy only).

Same public surface and field names as the reference ``MultiModNHistory``:
per-tag dicts of per-epoch ``(E+1, D)`` ndarrays for loss / accuracy /
sensitivity / specificity / balanced_accuracy, plus a ``state_change_loss``
list of ``(E,)`` arrays. The results table holds the last epoch's last
encoder row per target: ``print_results`` prints it and ``save_results``
writes it as the JAX package's pandas CSV, both without pandas;
``get_results`` returns it as a DataFrame and imports pandas when called.
``plot`` imports matplotlib when called (an ``ImportError`` where it is
missing) and works with a single tag too (quirk #15).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from multimodn_tpu_torch.data.table import format_column, write_rows


class MultiModNHistory:
    """Training history of MultiModN."""

    def __init__(self, targets: List[str]):
        self.decoder_names: List[str] = list(targets)
        self.state_change_loss: List[np.ndarray] = []
        self.loss: Dict[str, List[np.ndarray]] = {"train": []}
        self.accuracy: Dict[str, List[np.ndarray]] = {"train": []}
        self.sensitivity: Dict[str, List[np.ndarray]] = {"train": []}
        self.specificity: Dict[str, List[np.ndarray]] = {"train": []}
        self.balanced_accuracy: Dict[str, List[np.ndarray]] = {"train": []}

    @property
    def _metric_stores(self):
        return {
            "loss": self.loss,
            "accuracy": self.accuracy,
            "sensitivity": self.sensitivity,
            "specificity": self.specificity,
            "balanced_accuracy": self.balanced_accuracy,
        }

    def append_epoch(self, tag: str, metrics: dict, state_change=None):
        """Record one epoch of (E+1, D) grids under ``tag``.

        ``state_change`` is only recorded for training epochs (the reference
        appends it in train_epoch only — ``multimodn.py:245``).
        """
        for name, store in self._metric_stores.items():
            if tag not in store:
                store[tag] = []
            store[tag].append(np.asarray(metrics[name]))
        if state_change is not None:
            self.state_change_loss.append(np.asarray(state_change))

    def plot(self, filepath: str, targets_to_display: List[str],
             show_state_change: bool = False):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n_cols = len(self.loss)
        metric_rows = [
            ("Loss", self.loss),
            ("Accuracy", self.accuracy),
            ("Sensitivity", self.sensitivity),
            ("Specificity", self.specificity),
            ("Balanced Accuracy", self.balanced_accuracy),
        ]
        n_rows = len(metric_rows)
        fig, ax = plt.subplots(figsize=(10 * n_cols, 5 * n_rows),
                               nrows=n_rows, ncols=n_cols, squeeze=False)

        if show_state_change and self.state_change_loss:
            ax[0][0].plot([sc[-1] for sc in self.state_change_loss],
                          label="State change loss")

        for target_name in targets_to_display:
            if target_name not in self.decoder_names:
                raise ValueError(
                    f"Target name '{target_name}' is not part of the MultiModN history"
                )
            idx = self.decoder_names.index(target_name)
            for row_idx, (metric_title, store) in enumerate(metric_rows):
                for col_idx, (key, value) in enumerate(store.items()):
                    # Final-encoder-row curve per epoch (history.py:58).
                    ax[row_idx][col_idx].plot(
                        [epoch_grid[-1][idx] for epoch_grid in value],
                        label=f"{target_name}")
                    ax[row_idx][col_idx].legend(loc="best")
                    ax[row_idx][col_idx].set_title(
                        f"{key.capitalize()} {metric_title}")
                    ax[row_idx][col_idx].grid(True)

        plt.tight_layout()
        fig.savefig(filepath)
        plt.close(fig)

    def _results(self):
        """``(columns, results)``: the last epoch's final-encoder-row metric
        per target (rows) and per tag and metric (columns), float64, after
        the state change loss column. Never-populated tags (the pre-created
        empty 'train' when only evaluation epochs were recorded) are
        skipped."""
        stores = {
            name: {k: v for k, v in store.items() if len(v) > 0}
            for name, store in self._metric_stores.items()
        }
        n_metrics = sum(len(s) for s in stores.values()) + 1
        results = np.zeros((len(self.decoder_names), n_metrics))
        columns = ["State change loss"]
        # The same value in each target's row (history.py:108).
        results[:, 0] = self.state_change_loss[-1][-1] \
            if self.state_change_loss else 0.0
        col = 1
        for name, store in stores.items():
            for key, value in store.items():
                columns.append(f"{display_title(key)} {name.replace('_', ' ')}")
                results[:, col] = value[-1][-1]
                col += 1
        return columns, results

    def get_results(self):
        """The results table as a pandas DataFrame indexed by target name;
        pandas is imported here, as the JAX package's API returns one."""
        import pandas as pd

        columns, results = self._results()
        df = pd.DataFrame(results, columns=columns)
        df.index = self.decoder_names
        return df

    def print_results(self):
        """Print the results table: one row per target, one column per tag
        and metric."""
        columns, results = self._results()
        cells = [["Target"] + columns] + [
            [name] + [f"{v:.6g}" for v in row]
            for name, row in zip(self.decoder_names, results)]
        widths = [max(len(r[c]) for r in cells) for c in range(len(cells[0]))]
        for r in cells:
            print("  ".join([r[0].ljust(widths[0])] + [
                v.rjust(w) for v, w in zip(r[1:], widths[1:])]))

    def save_results(self, path):
        """Write the results table as CSV, byte for byte the JAX package's
        ``get_results().to_csv(path, index_label="Target")``."""
        columns, results = self._results()
        with open(path, "w", newline="") as f:
            write_rows(f, ["Target"] + columns,
                       [[str(n) for n in self.decoder_names]]
                       + [format_column(c) for c in results.T])


def display_title(key: str) -> str:
    return key.replace("_", " ").capitalize()
