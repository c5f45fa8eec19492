"""Host milliseconds per scoring request: the benchmark's span around each
``fused_forward`` call up to its return (the host's enqueue time), over the
untraced slice that precedes the traced one, so the profiler's own cost is
not in it."""
SPAN = "score.fused_forward"


def read(r):
    spans = [e - s for name, s, e, traced in r.spans
             if name == SPAN and not traced]
    return 1e3 * sum(spans) / len(spans) if spans else None
