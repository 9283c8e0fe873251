"""Device idle at each update's first graph launch in the traced window:
the graph's first stage stamp less the program's ``launch`` stamp, queued
just before that launch after the noise and state copies (mean over the
window's updates)."""
from benchmark.metrics._program_trace import mean_of


def read(ctx):
    return mean_of(ctx, "launch_wait_ms")
