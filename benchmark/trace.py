"""Reductions from a torch.profiler trace to the benchmark's numbers.

``device_window`` reads a profiled stretch of the timed loop: the device's
busy time (the union of its kernels, copies and sets), the kernels by name,
and the longest idle gaps with what the host was doing then.
``stage_times`` reads one eager step: each kernel goes to the chain of
scopes (``record_function`` names) of the op that launched it. Frozen here:
the program gives only its scope names and kernel names.
"""
from __future__ import annotations

import collections
import re
from typing import Dict, List, Tuple

# the program's scopes of its own step's move generation, and of the 2-ply
# scorer's reply enumerations (names from the program's ``scope`` calls)
MOVEGEN_RE = re.compile(r"nd_front|nd_tail\w*|dd_L\d|slotv|sel|take|mg_merge")
REPLY_RE = re.compile(r"ndpass|nd\d\d|dd\d|score")


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return getattr(e, "device_type", None) == DeviceType.CUDA and not getattr(
        e, "is_user_annotation", False)


def device_window(prof, spans: List[Tuple[str, float, float]]) -> Dict[str, object]:
    """Busy and idle device time of a profiled stretch. ``spans`` are the
    benchmark's own (name, start, end) host spans in the profiler's clock
    (microseconds), used to say what the host did during each idle gap.
    Returns busy_s, window_s (first to last device activity, or the spans'
    extent when wider), kernels (count), by_name {name: (s, count)} and
    idle_gaps [(label, s)], longest first."""
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events if _is_device(e))
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if not _is_device(e) and getattr(e, "device_type", None) is not None
                 and not getattr(e, "is_user_annotation", False))
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    busy, cur_s, cur_e = 0.0, None, None
    gaps: List[Tuple[float, float]] = []
    for s, e, name in dev:
        by_name[name][0] += (e - s) / 1e6
        by_name[name][1] += 1
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    lo = min([s for s, _, _ in dev] + [s for _, s, _ in spans], default=0.0)
    hi = max([e for _, e, _ in dev] + [e for _, _, e in spans], default=0.0)

    def label(g0: float, g1: float) -> str:
        mid = (g0 + g1) / 2
        span = next((n for n, s, e in spans if s <= mid <= e), "outside spans")
        op = ""
        for s, e, n in cpu:
            if s > mid:
                break
            if e >= g0:
                op = n
        return f"{span}: {op}" if op else span

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy / 1e6,
        "window_s": (hi - lo) / 1e6,
        "kernels": sum(n for _, n in by_name.values()),
        "by_name": {k: (v[0], int(v[1])) for k, v in by_name.items()},
        "idle_gaps": [(label(a, b), (b - a) / 1e6) for a, b in gaps[:10]],
    }


def kernel_seconds(by_name: Dict[str, Tuple[float, int]], pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name contains ``pattern``."""
    hits = [v for k, v in by_name.items() if pattern in k]
    return sum(s for s, _ in hits), sum(n for _, n in hits)


def stage_times(prof) -> Dict[str, float]:
    """Device ms of one eager step by layer: ``movegen`` (kernels under a
    scope of the step's own move generation and under no reply scope),
    ``twoply`` (kernels under a reply scope of the 2-ply scorer) and
    ``traced`` (every device event). Each kernel is linked by the profiler
    to the op or scope that launched it; its scopes are that event's chain
    of enclosing events."""
    out = {"movegen": 0.0, "twoply": 0.0, "traced": 0.0, "attributed": 0.0}
    events = prof.events()
    for e in events:
        if _is_device(e):
            out["traced"] += (e.time_range.end - e.time_range.start) / 1e3
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        chain = []
        p = e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        ms = sum(k.duration for k in kernels) / 1e3
        out["attributed"] += ms
        if any(REPLY_RE.fullmatch(n) for n in chain):
            out["twoply"] += ms
        elif any(MOVEGEN_RE.fullmatch(n) for n in chain):
            out["movegen"] += ms
    return out
