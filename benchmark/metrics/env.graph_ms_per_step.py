"""Device ms of the ``env`` stage a step in the traced window, by the program's
own clock inside the graphed step: the env step, the reset and the step's
``Transition``, between the device stamps the tracer writes at its start and
at the next stage's start (the first step of every captured chunk, in each
update of the window; the mean over them)."""
from benchmark.metrics._program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "env")
