"""Profiling utilities.

Port of ``mlp_ppo_2ply_multi_tpu/utils/profiling.py``: the reference's
wall-clock accumulators (decorator.py:4-21, backgammon_env.py:331-341),
with timers that wait for the card. PyTorch returns before the device
finishes, so ``profile`` and ``timed`` call ``torch.cuda.synchronize`` on
every card the result holds a tensor on (JAX: ``block_until_ready``).
``device_op_times`` is the op-level device view from ``torch.profiler``.

``scope`` is the counterpart of ``jax.named_scope``: the engine, the actor
and the 2-ply scorer label their stages with it, under JAX's names.
``device_stage_times`` groups one call's device time by those stages, as
JAX's ``scripts/trace_attr.py`` groups its fusions.

torch.profiler now and then drops kernel records on the card's machine (17
of 20 launches in one trace), so nothing may gate on ``device_op_times`` or
``device_stage_times``: time kernels with CUDA events.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import re
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Set, Tuple

import torch

profiling_data: Dict[str, Dict[str, float]] = collections.defaultdict(
    lambda: {"calls": 0, "total_s": 0.0}
)


def _cuda_devices(x, into: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor in ``x`` (a tensor, or dicts,
    lists, tuples and NamedTuples of them)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            into.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, into)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, into)
    return into


def synchronize(x) -> None:
    """Wait until every card ``x`` holds a tensor on has finished its work."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


def _add(name: str, dt: float) -> None:
    d = profiling_data[name]
    d["calls"] += 1
    d["total_s"] += dt


def profile(fn: Callable) -> Callable:
    """Decorator accumulating synchronized wall time per function (the
    reference's @profile, waiting for the card so its time is counted)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        _add(fn.__qualname__, time.perf_counter() - t0)
        return out

    return wrapper


def print_profiling_data() -> None:
    for name, d in sorted(profiling_data.items(), key=lambda kv: -kv[1]["total_s"]):
        calls = int(d["calls"])
        avg = d["total_s"] / max(calls, 1)
        print(f"{name}: {calls} calls, total {d['total_s']:.3f}s, avg {avg*1000:.2f}ms")


@contextlib.contextmanager
def timed(name: str, sync_on=None) -> Iterator[None]:
    """Time a block under ``name``; pass the block's result (tensors, or
    containers of them) as ``sync_on`` to wait for its device work."""
    t0 = time.perf_counter()
    yield
    synchronize(sync_on)
    _add(name, time.perf_counter() - t0)


def device_op_times(fn: Callable, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once as a warm-up, then once under torch.profiler,
    and return {device op name: ms} summed over the trace's device events
    (kernels, copies, sets), largest first. Device events only: the profiler
    also gives each CPU op its kernels' device time, and each ``scope`` a
    device span over its kernels (``device_events``). {} when the result
    holds no CUDA tensor (the JAX function keeps TPU events only)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out = fn(*args)
    if not _cuda_devices(out, set()):
        return {}
    synchronize(out)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synchronize(fn(*args))
    agg: Dict[str, float] = collections.defaultdict(float)
    for e in device_events(prof.key_averages()):
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        agg[e.key] += us / 1e3
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]))


def device_events(events) -> list:
    """The device events of a trace (kernels, copies, sets), without the
    device spans the profiler adds for each ``record_function``: a scope's
    span covers the kernels inside it, so a sum over both counts them twice."""
    from torch.autograd import DeviceType

    return [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_memory_stats(device=None) -> Dict[str, float]:
    """Device memory of one card in MB (the reference's NVML prints around
    each update, trainer.py:54-62,170-184), under the JAX package's keys:
    ``hbm_used_mb`` (allocated by tensors now), ``hbm_limit_mb`` (the card's
    total memory) and ``hbm_peak_mb`` (the most allocated since the last
    reset of the peak). {} for a CPU device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    mb = 1.0 / (1024 * 1024)
    return {
        "hbm_used_mb": torch.cuda.memory_allocated(dev) * mb,
        "hbm_limit_mb": torch.cuda.get_device_properties(dev).total_memory * mb,
        "hbm_peak_mb": torch.cuda.max_memory_allocated(dev) * mb,
    }


# ---------------------------------------------------------------------------
# stages: the counterpart of jax.named_scope
# ---------------------------------------------------------------------------

# the scope names a stage tag is made of (JAX scripts/trace_attr.py:102-114)
STAGE_RE = re.compile(
    r"(nd\d\d|dd\d|nd_front|nd_tail\w*|dd_L\d|slotv|sel|take|roll\d+|mg_merge|act_t\d|env_step)"
)

_entered = threading.local()  # .names: this thread's open scopes, outermost first


def scopes() -> Tuple[str, ...]:
    """The scopes open on this thread, outermost first."""
    return tuple(getattr(_entered, "names", ()))


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """Label a stage of work: a ``torch.profiler.record_function`` of
    ``name`` (the JAX package's ``jax.named_scope`` name), also kept on this
    thread's scope stack for ``utils.cost``. Host-only: it adds no device op
    and no synchronisation, and is legal inside a CUDA graph capture, whose
    replays run no Python."""
    names = _entered.__dict__.setdefault("names", [])
    with torch.profiler.record_function(name):
        names.append(name)
        try:
            yield
        finally:
            names.pop()


def stage_tag(names: Iterable[str], fallback: str) -> str:
    """The stage tag of work done inside the scopes ``names`` (outermost
    first): the names that ``STAGE_RE`` matches, joined by "/", as JAX's
    trace_attr joins a fusion's scope path; ``fallback`` (a kernel's or an
    op's name) when none does."""
    return "/".join(n for n in names if STAGE_RE.fullmatch(n)) or fallback


class StageTimes(NamedTuple):
    """One call's device time by stage tag."""

    stages: Dict[str, Tuple[float, int]]  # tag -> (device ms, device ops), largest first
    attributed_ms: float  # the device ms ``stages`` holds
    traced_ms: float  # every device event of the trace, attributed or not


def attribute_kernels(events) -> Tuple[Dict[str, Tuple[float, int]], float]:
    """({tag: (device ms, ops)}, ms attributed) from a trace's events: each
    device event the profiler linked to the CPU event that launched it (an
    op or a scope, ``FunctionEvent.kernels``) goes to ``stage_tag`` of that
    event's chain of enclosing events (``cpu_parent``), with the device
    event's name as the fallback."""
    agg: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        chain: List[str] = []
        p = e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        chain.reverse()
        for k in kernels:
            a = agg[stage_tag(chain, k.name)]
            a[0] += k.duration / 1e3
            a[1] += 1
    stages = {t: (ms, int(n)) for t, (ms, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])}
    return stages, sum(ms for ms, _ in stages.values())


def device_stage_times(fn: Callable, *args) -> StageTimes:
    """Run ``fn(*args)`` once under torch.profiler and group its device
    events by the stage that launched them (``attribute_kernels``). Warm
    ``fn`` up first. Attribution follows the profiler's links from a kernel
    to the CPU op that launched it, so it needs an eager call: a CUDA graph
    replay links every kernel to ``cudaGraphLaunch``. The call runs inside
    one more scope, so a kernel launched outside any op (the port's ctypes
    kernels) still has an event to link to. Empty when the result holds no
    CUDA tensor."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with scope("device_stage_times"):
            out = fn(*args)
        synchronize(out)
    if not _cuda_devices(out, set()):
        return StageTimes({}, 0.0, 0.0)
    events = prof.events()
    stages, attributed = attribute_kernels(events)
    traced = sum(e.time_range.elapsed_us() for e in device_events(events)) / 1e3
    return StageTimes(stages, attributed, traced)


def queued_ms_per_round(fns, dev: torch.device, rounds: int = 10) -> float:
    """Device ms per round of calling every fn once: CUDA events around
    ``rounds`` rounds that the host queued while a spin kernel held the
    card, so the events time the kernels back to back, whatever the host's
    launch rate (a loop timed with events alone measures the host where
    each launch is shorter than its Python wrapper). The spin grows until
    the card is still spinning when the host has queued the last launch;
    raises if it never is."""
    for f in fns:
        f()
    torch.cuda.synchronize(dev)
    cycles = 10**8  # ~50 ms at the H100's 1.98 GHz boost clock
    for _ in range(4):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(rounds):
            for f in fns:
                f()
        e1.record()
        queued_ahead = not e0.query()
        torch.cuda.synchronize(dev)
        if queued_ahead:
            return e0.elapsed_time(e1) / rounds
        cycles *= 8
    raise AssertionError("the host could not queue the timed launches ahead of the card")
