"""Host milliseconds of the training step's optimizer per step: the program's
``step.optimizer`` spans under the traced slice's ``train.step`` spans."""
from benchmark.harness import program_spans


def read(r):
    return program_spans.per_step_ms(r, "step.optimizer")
