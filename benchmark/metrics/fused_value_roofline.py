"""B1's share of its roofline in a profiled update: the frozen bound
(``yardstick.fused_value_bound``) over the rows the step has to value -- the
legal afterstates of every decision, and in 2-ply the replies of each
reranked candidate, the small doubles cut to the algorithm's cap (an
estimate: the reference's mean over the candidates it scored, until the
program counts the rows it values) -- over the device time of the
``fused_value_kernel`` launches in the trace."""
from benchmark import yardstick as Y
from benchmark.trace import kernel_seconds


def read(ctx):
    p = ctx.prof
    if not p:
        return None
    secs, launches = kernel_seconds(p["by_name"], "fused_value_kernel")
    c = p["counts"]
    moves = sum(x["moves"] for x in c)
    decisions = sum(x["decisions"] for x in c)
    if secs <= 0 or decisions <= 0:
        return None
    rows = moves
    if ctx.cfg.twoply.enabled:
        per = ctx.ref.get("replies_per_candidate") or 0.0
        if per <= 0:
            return None
        rows += sum(x["twoply_decisions"] for x in c) * ctx.cfg.twoply.top_k_candidates * per
    nnz = sum(x["nnz"] for x in c) / decisions
    b = Y.fused_value_bound(rows, nnz, launches, ctx.cfg.model.hidden_size)
    return 100.0 * b["bound_ms"] / (secs * 1e3)
