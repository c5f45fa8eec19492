"""The training step's share of the card's fp32 peak: the useful model
FLOPs of the traced slice (``counts/<config>.py``: present cells only,
three forward passes a step) per second of the slice, over the peak of
``peaks.json``."""


def read(r):
    if not r.counts.get("steps"):
        return None
    return 100.0 * r.counts["useful_flops"] / r.view.window_s \
        / r.peak[r.counts["peak_flops"]]
