"""Megabytes copied from the host to the card per training step: the
``bytes`` of the program's ``loader.to_device`` spans under the traced
slice's ``loader.stacks`` builds, over the slice's steps."""
from benchmark.harness import program_spans


def read(r):
    found = program_spans.loader_builds(r)
    if not found:
        return None
    builds, spans, steps = found
    ids = {s.id for s in builds}
    copies = [s.attrs["bytes"] for s in spans
              if s.name == "loader.to_device" and s.parent in ids]
    return sum(copies) / steps / 1e6 if copies else None
