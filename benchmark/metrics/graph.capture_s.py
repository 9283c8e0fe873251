"""Seconds the program spent capturing and instantiating CUDA graphs in
set-up: the ``capture_s`` of its ``capture`` spans that started before
the traced window (the chunk graph, captured by the first update)."""
from benchmark.metrics._program_trace import setup_attr


def read(ctx):
    return setup_attr(ctx, "capture", "capture_s")
