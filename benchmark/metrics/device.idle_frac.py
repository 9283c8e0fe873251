"""Share of a profiled update of the window (rollout, learner and host
pull) in which no kernel, copy or set ran on the device."""


def read(ctx):
    p = ctx.prof
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
