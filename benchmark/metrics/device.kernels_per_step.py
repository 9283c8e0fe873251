"""Device kernels, copies and sets of a profiled update, per rollout step
(the learner's and the pull's included)."""


def read(ctx):
    p = ctx.prof
    if not p or not p["kernels"]:
        return None
    return p["kernels"] / p["steps"]
