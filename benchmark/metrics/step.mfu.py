"""The whole update's share of the H100's bf16 peak: the value-net
operations the algorithm defines (the forward over every legal afterstate
valued, in 2-ply also over the replies of each reranked candidate, the
small doubles cut to the algorithm's cap (an estimate from the reference's
mean over the candidates it scored, until the program counts the rows it
values), and the learner's forward and backward over the recorded rows) counted from
what the traced updates produced, over their mean host time (rollout,
learner and pull spans)."""
import statistics

from benchmark import yardstick as Y


def read(ctx):
    if not ctx.counts or not ctx.spans:
        return None
    h, n_in = ctx.cfg.model.hidden_size, ctx.cfg.model.input_size
    c = ctx.counts
    rows = statistics.fmean(x["moves"] for x in c)
    if ctx.cfg.twoply.enabled:
        per = ctx.ref.get("replies_per_candidate") or 0.0
        if per <= 0:
            return None
        rows += statistics.fmean(x["twoply_decisions"] for x in c) * \
            ctx.cfg.twoply.top_k_candidates * per
    flops = Y.value_flops(rows, n_in, h) + Y.learner_flops(
        statistics.fmean(x["decisions"] for x in c), n_in, h)
    secs = sum(e - s for _, s, e in ctx.spans) / len(c)
    return 100.0 * flops / (secs * Y.BF16_FLOP_PER_S)
