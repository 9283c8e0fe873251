"""Device ms of the step's own move generation in one eager step after the
window: kernels under the program's movegen scopes (nd_front, nd_tail*,
dd_L*, slotv, sel, take, mg_merge) and under none of the 2-ply scorer's
reply scopes (``trace.stage_times``)."""


def read(ctx):
    if not ctx.eager or ctx.eager["attributed"] <= 0:
        return None
    return ctx.eager["movegen"]
