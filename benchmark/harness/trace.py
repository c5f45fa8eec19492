"""The traced slice of a run: ``torch.profiler`` over the host and the card,
kept in memory, reduced here to what the per-layer readers and the result's
``breakdown`` need. Nothing is written to disk."""
import contextlib
import time

import numpy as np
import torch

WINDOW = "bench.window"
GAPS_ATTRIBUTED = 400       # the longest idle gaps named by the host's op


@contextlib.contextmanager
def profiled(run, host: bool):
    """Profile the block as one ``bench.window`` range; yields a holder
    whose ``view`` is set once the block has ended. ``host``: record the
    host's ops as well as the card's, which costs the host time per op
    and so widens the card's idle gaps; without it only the card's
    activity is kept and the window is the host clock's."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Traced", (), {})()
    activities = [ProfilerActivity.CPU] if host else []
    if run.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    run.traced = True
    run.sync()
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield holder
            run.sync()
        seconds = time.perf_counter() - start
    run.traced = False
    holder.view = View(prof.events(), {name for name, *_ in run.spans},
                       None if host else seconds)


class View:
    """Device and host events of the traced window, times in seconds."""

    def __init__(self, events, annotations, seconds=None):
        """``seconds``: the window's length on the host clock, where the
        trace holds no host range to take it from."""
        device, host = [], []
        window = None
        for e in events:
            start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.name in annotations or e.name == WINDOW:
                    continue            # ranges mirrored onto the card
                device.append((e.name, start, end))
            else:
                if e.name == WINDOW:
                    window = (start, end)
                host.append((e.name, start, end))
        if window is None and device and seconds is not None:
            first = min(s for _n, s, _e in device)
            window = (first, first + seconds)
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        self.window = window
        self.window_s = window[1] - window[0]
        self.device = [d for d in device
                       if d[2] > window[0] and d[1] < window[1]]
        self.kernels = [d for d in self.device if not _is_copy(d[0])]
        self.host = host
        self._busy = _merge([(max(s, window[0]), min(e, window[1]))
                             for _n, s, e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def top_ops(self, k=10):
        totals = {}
        for n, s, e in self.device:
            totals[n] = totals.get(n, 0.0) + (e - s)
        return sorted(([n, t] for n, t in totals.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """The idle time between device ops, by what the host was doing in
        the middle of each gap: the longest ``GAPS_ATTRIBUTED`` gaps by the
        innermost host op (and the innermost non-runtime op around it), the
        rest summed as one entry."""
        edges = [self.window[0]] + [x for iv in self._busy for x in iv] + \
            [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named, rest = gaps[:GAPS_ATTRIBUTED], gaps[GAPS_ATTRIBUTED:]
        host = [h for h in self.host if h[0] != WINDOW]
        starts = np.array([h[1] for h in host])
        ends = np.array([h[2] for h in host])
        totals = {}
        for s, e in named:
            mid = 0.5 * (s + e)
            idx = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = "host: none"
            if idx.size:
                idx = idx[np.argsort(starts[idx])]
                inner = host[idx[-1]][0]
                ops = [host[i][0] for i in idx
                       if not host[i][0].startswith("cuda")]
                name = "host: " + (ops[-1] if ops else inner)
                if ops and ops[-1] != inner:
                    name += " / " + inner
            totals[name] = totals.get(name, 0.0) + (e - s)
        out = sorted(([n, t] for n, t in totals.items()),
                     key=lambda x: -x[1])[:k - 1]
        if rest:
            out.append([f"{len(rest)} shorter gaps",
                        sum(e - s for s, e in rest)])
        return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]
