"""Mean host time of ``td.update`` in the traced window: the benchmark's
span around it, from the rollout's end to a synchronisation."""
import statistics


def read(ctx):
    ms = [(e - s) * 1e3 for n, s, e in ctx.spans or () if n == "learner"]
    return statistics.fmean(ms) if ms else None
