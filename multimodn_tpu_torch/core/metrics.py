"""Metrics (PyTorch twin of ``multimodn_tpu/core/metrics.py``): confusion
counts, the safe division and the rank-sum AUROC on tensors, and the
end-of-training 15-tuple suite on numpy arrays (copied from the JAX package,
which computes it in numpy too)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

performance_metrics = [
    "f1", "auc", "accuracy", "sensitivity", "specificity", "fpr", "tpr",
    "precision", "recall", "tn", "fp", "fn", "tp", "thr_roc", "thr_pr",
]


def binary_confusion_counts(pred: torch.Tensor, target: torch.Tensor,
                            mask: Optional[torch.Tensor] = None):
    """(tp, tn, fp, fn) float32 sums over the last axis of (..., B)
    inputs."""
    m = torch.ones(pred.shape, device=pred.device) if mask is None \
        else mask.float()
    p1, t1 = pred.long() == 1, target.long() == 1
    zero = torch.zeros((), device=pred.device)
    return tuple(torch.where(sel, m, zero).sum(dim=-1)
                 for sel in (p1 & t1, ~p1 & ~t1, p1 & ~t1, ~p1 & t1))


def safe_div(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """num/denom with 0 where denom == 0 (reference ``multimodn.py:234``)."""
    zero = denom == 0
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(denom), denom))


def masked_binary_auroc(probs: torch.Tensor, labels: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Exact binary AUROC by the rank-sum (Mann-Whitney U) statistic with
    tie-averaged ranks, equal to trapezoidal ROC integration; 0 when a class
    is absent. Invalid rows take +inf and the top ranks, leaving the valid
    rows' ranks unchanged."""
    probs = probs.float()
    v = valid.float() > 0
    pos = v & (labels == 1)
    neg = v & (labels == 0)
    x = torch.where(v, probs, torch.full_like(probs, float("inf")))
    sorted_x = torch.sort(x).values
    left = torch.searchsorted(sorted_x, x, side="left")
    right = torch.searchsorted(sorted_x, x, side="right")
    rank = 0.5 * (left + right + 1).float()
    n_pos = pos.float().sum()
    n_neg = neg.float().sum()
    u = torch.where(pos, rank, torch.zeros_like(rank)).sum() \
        - n_pos * (n_pos + 1.0) / 2.0
    denom = n_pos * n_neg
    return torch.where(denom > 0, u / denom.clamp_min(1.0),
                       torch.zeros_like(u))


# --------------------------------------------------------------------------
# Host-side end-of-training suite (numpy)
# --------------------------------------------------------------------------

def _roc_curve(y_true: np.ndarray, y_prob: np.ndarray):
    """ROC curve at thresholds = descending unique probabilities, prefixed by a
    (0,0) point at threshold 1.0 — matching torchmetrics.ROC(task='binary')."""
    if y_true.size == 0:
        z = np.zeros(1)
        return z, z, np.ones(1)
    order = np.argsort(-y_prob, kind="stable")
    y_true = y_true[order]
    y_prob = y_prob[order]
    distinct = np.where(np.diff(y_prob))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    n_pos = max(float(tps[-1]) if tps.size else 0.0, 0.0)
    n_neg = max(float(fps[-1]) if fps.size else 0.0, 0.0)
    tpr = tps / n_pos if n_pos > 0 else np.zeros_like(tps)
    fpr = fps / n_neg if n_neg > 0 else np.zeros_like(fps)
    tpr = np.r_[0.0, tpr]
    fpr = np.r_[0.0, fpr]
    thresholds = np.r_[1.0, y_prob[idx]]
    return fpr, tpr, thresholds


def _pr_curve(y_true: np.ndarray, y_prob: np.ndarray):
    """Precision-recall curve matching torchmetrics.PrecisionRecallCurve
    (binary): points at descending unique thresholds, final (p=1, r=0) anchor."""
    if y_true.size == 0:
        return np.ones(1), np.zeros(1), np.zeros(0)
    order = np.argsort(-y_prob, kind="stable")
    y_true = y_true[order]
    y_prob = y_prob[order]
    distinct = np.where(np.diff(y_prob))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    n_pos = float(tps[-1]) if tps.size else 0.0
    precision = np.where(tps + fps > 0, tps / np.maximum(tps + fps, 1), 0.0)
    recall = tps / n_pos if n_pos > 0 else np.zeros_like(tps)
    # torchmetrics reverses to ascending-threshold order and anchors (1, 0).
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    thresholds = y_prob[idx][::-1]
    return precision, recall, thresholds


def _auc_trapezoid(x: np.ndarray, y: np.ndarray) -> float:
    if x.size < 2:
        return 0.0
    return float(np.trapezoid(y, x))


def compute_metrics(tp, tn, fp, fn, cm, enc_idx, dec_idx):
    """Reference-compat helper (``multimodn/multimodn.py:51-63``): scatter
    one (2, 2) confusion matrix into the (E+1, D) count grids in place, or
    NaN-fill the cell when the decoder is non-binary (cm None)."""
    if cm is not None:
        cm = np.asarray(cm)
        tp[enc_idx][dec_idx] += cm[1][1]
        tn[enc_idx][dec_idx] += cm[0][0]
        fp[enc_idx][dec_idx] += cm[0][1]
        fn[enc_idx][dec_idx] += cm[1][0]
    else:
        tp[enc_idx][dec_idx] = float("nan")
        tn[enc_idx][dec_idx] = float("nan")
        fp[enc_idx][dec_idx] = float("nan")
        fn[enc_idx][dec_idx] = float("nan")


def get_performance_metrics(y_true, y_pred, y_prob) -> Tuple:
    """Binary-classification suite; same 15-tuple as the reference
    (``multimodn/multimodn.py:22-49``).

    Args:
        y_true: (N,) 0/1 ground truth.
        y_pred: (N,) 0/1 hard predictions (used for accuracy & confusion).
        y_prob: (N,) positive-class probabilities (used for f1/auroc/curves —
            torchmetrics thresholds probabilities at 0.5 for binary F1).
    """
    y_true = np.asarray(y_true).astype(np.int64).reshape(-1)
    y_pred = np.asarray(y_pred).astype(np.int64).reshape(-1)
    y_prob = np.asarray(y_prob, dtype=np.float64).reshape(-1)

    # F1 on probabilities thresholded STRICTLY above 0.5, like torchmetrics'
    # binary F1 (reference multimodn.py:48).
    pred_t = (y_prob > 0.5).astype(np.int64)
    tp_f = float(np.sum((pred_t == 1) & (y_true == 1)))
    fp_f = float(np.sum((pred_t == 1) & (y_true == 0)))
    fn_f = float(np.sum((pred_t == 0) & (y_true == 1)))
    f1 = 2 * tp_f / (2 * tp_f + fp_f + fn_f) if (2 * tp_f + fp_f + fn_f) > 0 else 0.0

    fpr, tpr, thr_roc = _roc_curve(y_true, y_prob)
    auroc = _auc_trapezoid(fpr, tpr)

    accuracy = float(np.mean(y_pred == y_true)) if y_true.size else 0.0

    tp = float(np.sum((y_pred == 1) & (y_true == 1)))
    tn = float(np.sum((y_pred == 0) & (y_true == 0)))
    fp = float(np.sum((y_pred == 1) & (y_true == 0)))
    fn = float(np.sum((y_pred == 0) & (y_true == 1)))
    sensitivity = tp / (tp + fn) if (tp + fn) != 0 else 0
    specificity = tn / (tn + fp) if (tn + fp) != 0 else 0

    precision, recall, thr_pr = _pr_curve(y_true, y_prob)

    return (f1, auroc, accuracy, sensitivity, specificity, fpr, tpr,
            precision, recall, tn, fp, fn, tp, thr_roc, thr_pr)
