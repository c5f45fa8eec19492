"""Device kernels per training step: kernels in the traced slice over the
training steps in it (copies and memsets not counted)."""


def read(r):
    steps = r.counts.get("steps")
    return len(r.view.kernels) / steps if steps else None
