"""Device ms of the 2-ply scorer's reply enumerations and scoring in one
eager step after the window: kernels under the reply scopes (ndpass,
nd{hi}{lo}, dd{die}, score; ``trace.stage_times``)."""


def read(ctx):
    if not ctx.eager or ctx.eager["twoply"] <= 0:
        return None
    return ctx.eager["twoply"]
