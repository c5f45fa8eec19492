"""Host milliseconds of the loader per training step: the program's
``loader.stacks`` spans (the epoch's reorder and pad in numpy and its copy
to the card) of the traced slice, summed, over the slice's steps."""
from benchmark.harness import program_spans


def read(r):
    found = program_spans.loader_builds(r)
    if not found:
        return None
    builds, _spans, steps = found
    if not builds:
        return None
    return sum(s.end_ns - s.start_ns for s in builds) / steps / 1e6
