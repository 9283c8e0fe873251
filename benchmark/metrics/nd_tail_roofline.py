"""B2's share of its roofline in one eager step after the window: the
frozen bound (``yardstick.nd_tail_bound``) of the rows the kernel was
handed in that step, over the device time of that step's ``nd_tail_kernel``
launches."""
from benchmark import yardstick as Y
from benchmark.trace import kernel_seconds


def read(ctx):
    e = ctx.eager
    if not e or not e.get("nd_tail_calls"):
        return None
    secs, _ = kernel_seconds(e["by_name"], "nd_tail_kernel")
    if secs <= 0:
        return None
    bound_ms = sum(Y.nd_tail_bound(v, K)["bound_ms"] for v, K in e["nd_tail_calls"])
    return 100.0 * bound_ms / (secs * 1e3)
