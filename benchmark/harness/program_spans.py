"""The program's own spans of the traced slice, for the readers of
``metrics/``: the recorder of ``multimodn_tpu_torch.utils.profiling``
records while a ``torch.profiler`` session runs, so in a ``--trace 1`` run
it holds the slice under the card's trace and then the slice under the
host's, the same work each, and nothing else. The first half of the last
two slices' worth of a root span is the traced slice's.

A program without the recorder, or one that recorded fewer spans than two
slices hold, gives None."""


def recorded():
    """The program's recorded spans, or None where it has no recorder."""
    try:
        from multimodn_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def traced_slice(spans, root: str, n: int):
    """The traced slice's ``n`` spans named ``root`` and the span before
    them (None at the start of the record), or None where the record holds
    fewer than ``2 n``."""
    roots = [s for s in spans if s.name == root]
    if not n or len(roots) < 2 * n:
        return None
    first = len(roots) - 2 * n
    return roots[first:first + n], roots[first - 1] if first else None


def children_ms(spans, parents, name: str, per: int):
    """Milliseconds of the spans named ``name`` under ``parents``, per one
    of ``per``; None where there is none."""
    ids = {p.id for p in parents}
    found = [s.end_ns - s.start_ns for s in spans
             if s.name == name and s.parent in ids]
    return sum(found) / per / 1e6 if found else None


def per_step_ms(r, name: str):
    """Milliseconds of the ``train.step``'s child spans ``name`` per
    training step of the traced slice."""
    spans = recorded()
    steps = r.counts.get("steps")
    found = traced_slice(spans, "train.step", steps) if spans else None
    return None if found is None else children_ms(spans, found[0], name,
                                                  steps)


def loader_builds(r):
    """``(loader.stacks spans of the traced slice, every span, steps)``:
    the builds between the step before the slice and its last step; or
    None."""
    spans = recorded()
    steps = r.counts.get("steps")
    found = traced_slice(spans, "train.step", steps) if spans else None
    if found is None:
        return None
    (chosen, before) = found
    after = before.end_ns if before is not None else None
    builds = [s for s in spans if s.name == "loader.stacks"
              and s.end_ns <= chosen[-1].end_ns
              and (after is None or s.start_ns >= after)]
    return builds, spans, steps


def per_request_ms(r, name: str):
    """Milliseconds of the ``request``'s child spans ``name`` per request
    of the traced slice."""
    spans = recorded()
    requests = r.counts.get("requests")
    found = traced_slice(spans, "request", requests) if spans else None
    return None if found is None else children_ms(spans, found[0], name,
                                                  requests)
