"""Host milliseconds of packing per scoring request: the program's
``request.pack`` spans (the modalities packed into one tensor on the card)
under the traced slice's ``request`` spans."""
from benchmark.harness import program_spans


def read(r):
    return program_spans.per_request_ms(r, "request.pack")
