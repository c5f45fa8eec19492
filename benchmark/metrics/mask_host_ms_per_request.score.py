"""Host milliseconds of the NaN mask per scoring request: the program's
``request.mask`` spans (``isnan``, ``index_add_``, the validity mask,
``nan_to_num``) under the traced slice's ``request`` spans."""
from benchmark.harness import program_spans


def read(r):
    return program_spans.per_request_ms(r, "request.mask")
