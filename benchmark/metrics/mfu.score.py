"""The scoring request's share of the card's fp32 peak: the useful forward
FLOPs of the traced slice's requests (present cells only, every decoder on
every state) per second of the slice, over the peak of ``peaks.json``."""


def read(r):
    if not r.counts.get("requests"):
        return None
    return 100.0 * r.counts["useful_flops"] / r.view.window_s \
        / r.peak[r.counts["peak_flops"]]
