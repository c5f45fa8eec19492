"""One run of one cell: the state a driver reads (the cell, the seed, the
device), the benchmark's own spans, and the clock."""
import contextlib
import time

import torch


class Run:
    """``side`` is ``"program"`` in every run of the benchmark; the control
    and the planted faults (``calibrate.py``, the tests) name another."""

    def __init__(self, cell, seed: int, device, side: str = "program"):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.side = side
        self.spans = []          # (name, start s, end s, traced)
        self.traced = False

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span on the host clock, and a named range in a traced run."""
        start = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.spans.append((name, start, time.perf_counter(), self.traced))


def exact_math():
    """fp32 products everywhere, as both configurations state: no TF32 in
    cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_math():
    """The control's precision: TF32 products in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
