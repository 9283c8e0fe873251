"""Device ms of the learner (``td.update``) in the traced window, between
the program's device stamps at its begin and end: its own work, without
the benchmark's synchronisations (mean over the window's updates)."""
from benchmark.metrics._program_trace import mean_of


def read(ctx):
    return mean_of(ctx, "learner_ms")
