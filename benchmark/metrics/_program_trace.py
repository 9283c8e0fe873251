"""The program's tracer (``mlp_ppo_2ply_multi_tpu_torch.utils.profiling``),
read for the traced window: the updates whose ``rollout`` span starts
between the first start and the last end of the window's spans
(``ctx.spans``, the same ``time.perf_counter`` clock), and the set-up spans
that started before it. Every reader returns None, and raises nothing,
where the program keeps no such record (a version without the tracer, or
``MLP_PPO_TORCH_TRACE=0``) or the window holds none."""
import statistics


def _profiling():
    try:
        from mlp_ppo_2ply_multi_tpu_torch.utils import profiling
    except ImportError:
        return None
    ok = hasattr(profiling, "trace_records") and hasattr(profiling, "trace_spans")
    return profiling if ok else None


def window(ctx):
    """(first start, last end) of the window's spans, or None."""
    if not ctx.spans:
        return None
    return min(s for _, s, _ in ctx.spans), max(e for _, _, e in ctx.spans)


def records(ctx) -> list:
    """The program's records of the window's updates."""
    prof, w = _profiling(), window(ctx)
    if prof is None or w is None:
        return []
    return prof.trace_records(*w)


def stage_ms(ctx, name: str):
    """Mean device ms of stage ``name`` over the window's stamped steps."""
    ms = [st[name] for r in records(ctx) for st in r["stages"] if name in st]
    return statistics.fmean(ms) if ms else None


def mean_of(ctx, key: str):
    """Mean of the records' ``key`` over the window's updates that have it."""
    vals = [r[key] for r in records(ctx) if r.get(key) is not None]
    return statistics.fmean(vals) if vals else None


def setup_attr(ctx, span: str, attr: str):
    """Sum of attribute ``attr`` over the program's ``span`` spans that
    started before the window (set-up), or None where there are none."""
    prof, w = _profiling(), window(ctx)
    if prof is None or w is None:
        return None
    vals = [s.attrs[attr] for s in prof.trace_spans()
            if s.name == span and s.start < w[0] and attr in s.attrs]
    return float(sum(vals)) if vals else None
