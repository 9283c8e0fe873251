"""Mean host time of the rollout of an update in the traced window: the
benchmark's span around ``rollout_chunked``, ending in a synchronisation."""
import statistics


def read(ctx):
    ms = [(e - s) * 1e3 for n, s, e in ctx.spans or () if n == "rollout"]
    return statistics.fmean(ms) if ms else None
