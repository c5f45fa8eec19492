"""Host milliseconds of the training step's forward per step: the program's
``step.forward`` spans under the traced slice's ``train.step`` spans."""
from benchmark.harness import program_spans


def read(r):
    return program_spans.per_step_ms(r, "step.forward")
