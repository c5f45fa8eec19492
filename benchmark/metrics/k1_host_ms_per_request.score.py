"""Host milliseconds of K1's enqueue per scoring request: the program's
``k1.enqueue`` spans (layer table, input checks, device tables, pointers,
launches) under the traced slice's ``request`` spans."""
from benchmark.harness import program_spans


def read(r):
    return program_spans.per_request_ms(r, "k1.enqueue")
