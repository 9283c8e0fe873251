"""Profiling utilities.

Port of ``mlp_ppo_2ply_multi_tpu/utils/profiling.py``: the reference's
wall-clock accumulators (decorator.py:4-21, backgammon_env.py:331-341),
with timers that wait for the card. PyTorch returns before the device
finishes, so ``profile`` and ``timed`` call ``torch.cuda.synchronize`` on
every card the result holds a tensor on (JAX: ``block_until_ready``).
``device_op_times`` is the op-level device view from ``torch.profiler``.

torch.profiler now and then drops kernel records on the card's machine (17
of 20 launches in one trace), so nothing may gate on ``device_op_times``:
time kernels with CUDA events.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, Dict, Iterator, Set

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
    also gives each CPU op its kernels' device time. {} when the result
    holds no CUDA tensor (the JAX function keeps TPU events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out = fn(*args)
    if not _cuda_devices(out, set()):
        return {}
    synchronize(out)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synchronize(fn(*args))
    agg: Dict[str, float] = collections.defaultdict(float)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            agg[e.key] += us / 1e3
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]))


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
