"""Profiling utilities: stage scopes, the tracer, and the profiler's views.

Port of ``mlp_ppo_2ply_multi_tpu/utils/profiling.py``, less the reference's
wall-clock accumulators (``profile``, ``timed``), which waited for the card
and which nothing read: the tracer below times the step without waiting.
``device_op_times`` is the op-level device view from ``torch.profiler``.

``scope`` is the counterpart of ``jax.named_scope`` and the one call that
labels work: the engine, the actor and the 2-ply scorer label their stages
with it, under JAX's names. ``device_stage_times`` groups one call's device
time by those stages, as JAX's ``scripts/trace_attr.py`` groups its fusions.

The tracer (``Tracer``, one per process: ``TRACER``) records, in memory and
bounded, while ``MLP_PPO_TORCH_TRACE`` is not ``0`` (the default records):

* host spans: a ``scope(name, span=True)`` is also a span (name, start and
  end on ``time.perf_counter``, parent span, update number, attributes):
  ``rollout``, ``replay``, ``learner``, ``capture``, ``build``;
* device stamps: ``ops.stamp`` writes the device's clock into a ring of rows
  on the device, at the stage boundaries of the first step of every chunk of
  the rollout (``step_stamps``, ``stage``: ``movegen``, ``act`` or
  ``twoply``, ``env``), also inside a captured CUDA graph, around the
  chunk's tail (``chunk_tail``: the stack of its transitions and the copy
  of its final state), before each chunk's input copies (``replay_stamp``),
  at the update's first graph launch (``launch_stamp``) and around the
  learner (``learner``). So a chunk's device time from its replay stamp to
  its tail's end is stamped through, and so is the time between chunks,
  where the card waits for the host. The slot comes from a cursor on the device; the host
  counts the rows it launched (a graph's replay counts the rows captured in
  it), so it knows where each landed without reading the cursor; the
  cursor, copied with each update's rows, checks that count;
* counters, by update: graphs captured and kernels built or loaded (their
  ``capture`` and ``build`` spans); the launches, eager and replayed, of
  each kernel of the launch registry (``KERNELS``: every hand-written
  kernel registers itself) that has a ``counter`` name, read as the update
  opens and closes (``dd_kernel_launches``, ``nd_tail_kernel_launches``,
  ``mlp_kernel_launches``, ``nd_front_kernel_launches``); the growth of a
  registered kernel's device counters (D2's ``mlp_rows_needed`` and
  ``mlp_rows_computed``: the rows its callers needed valued and the rows
  it computed, int64 tensors it adds to), copied out without a wait as
  each update closes and read with the update's rows; and what the
  program counts by name (``count``: the plain doubles chain's calls on a
  card, ``dd_plain``, the plain tail's runs on a card, ``nd_tail_plain``,
  and the plain non-doubles front's, ``nd_front_plain``).

The launch registry (``KERNELS``, and the stamp writer ``CLOCK``) sits in
this, the lowest layer, so that nothing below the kernels imports them.

An update's rows are copied to pinned host memory without a wait when the
update closes (the learner's end, or the next rollout), and read once that
copy has landed (at the next rollout's end, while the card works through
its launches, or when records are asked for): ``trace_records`` may lag
one update, and adds no host synchronisation. ``trace_records(t0, t1)`` gives each update whose
``rollout`` span starts in [t0, t1] (stage ms of each stamped step, the
wait at the first graph launch, each chunk's device ms by part, the
learner's device ms, the host ms of the replays, captures and builds);
``trace_spans`` the set-up spans (captures,
builds). ``to_profiler_us`` and ``device_to_profiler_us`` put host spans
and device stamps on a torch.profiler trace's timeline;
``write_chrome_trace`` writes both on the host's clock.

torch.profiler now and then drops kernel records on the card's machine (17
of 20 launches in one trace), so nothing may gate on ``device_op_times`` or
``device_stage_times``: time kernels with CUDA events or the tracer.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import threading
import time
from typing import (Callable, Deque, Dict, Iterable, Iterator, List, NamedTuple, Optional, Set,
                    Tuple)

import torch


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
def scope(name: str, span: bool = False, **attrs) -> Iterator[Dict[str, object]]:
    """Label a stage of work: a ``torch.profiler.record_function`` of
    ``name`` (the JAX package's ``jax.named_scope`` name), also kept on this
    thread's scope stack for ``utils.cost``. A ``span`` is a host span's
    scope: its trace record is the profiler's fast record function
    (``_fast_record``), tracing on or off, and while tracing is on the
    tracer keeps it as a span, with ``attrs`` and what the block adds to the
    dict it is handed. Host-only: it adds no device op and no
    synchronisation, and is legal inside a CUDA graph capture, whose
    replays run no Python."""
    names = _entered.__dict__.setdefault("names", [])
    if not span:
        with torch.profiler.record_function(name):
            names.append(name)
            try:
                yield attrs
            finally:
                names.pop()
        return
    on, sp = tracing(), None
    try:
        with _fast_record(name):
            if on:
                # the trace record starts at the end of its entry call
                sp = TRACER.open_span(name, attrs)
            names.append(name)
            try:
                yield attrs
            finally:
                names.pop()
                inside = time.perf_counter()
    finally:
        if sp is not None:
            # the trace record ends inside its exit call, which takes tens of
            # us under CUDA tracing: the span ends at the call's midpoint
            TRACER.close_span(sp, (inside + time.perf_counter()) / 2)


def _fast_record(name: str):
    """A trace record of ``name`` cheap enough that a span's own stamps land
    within a few us of it on the profiler's timeline: a ``record_function``
    dispatches an op on entry and exit, and under CUDA tracing on an H100
    machine those took 60-130 us around a graph launch; the fast one took
    5 us on entry and ~35 on exit (so ``scope`` ends a span at the exit
    call's midpoint). It is not a user annotation (``is_user_annotation``
    is false); ``record_function`` where torch has no fast one."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(name) if fast is not None else torch.profiler.record_function(name)


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


def attribute_kernels(events, within: Optional[str] = None
                      ) -> Tuple[Dict[str, Tuple[float, int]], float]:
    """({tag: (device ms, ops)}, ms attributed) from a trace's events: each
    device event the profiler linked to the CPU event that launched it (an
    op or a scope, ``FunctionEvent.kernels``) goes to ``stage_tag`` of that
    event's chain of enclosing events (``cpu_parent``), with the device
    event's name as the fallback. ``within``: only the events inside a
    scope of that name."""
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
        if within is not None and within not in chain:
            continue
        for k in kernels:
            a = agg[stage_tag(chain, k.name)]
            a[0] += k.duration / 1e3
            a[1] += 1
    stages = {t: (ms, int(n)) for t, (ms, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])}
    return stages, sum(ms for ms, _ in stages.values())


def device_stage_times(fn: Callable, *args) -> StageTimes:
    """Run ``fn(*args)`` twice under one torch.profiler session and group
    the second call's device events by the stage that launched them
    (``attribute_kernels``). The first call is a lead-in, waited for before
    the second: late in a long process the profiler kept no record of a
    session's first ~21 kernels, whatever ran or waited before them (a
    spin kernel, a host sleep; H100 machine), and the lead-in's kernels
    take that loss where ``fn`` launches more than that (a step launches
    hundreds; a call of one kernel is attributed in an interpreter of its
    own). Warm ``fn`` up first. Attribution follows the profiler's links from a kernel
    to the CPU op that launched it, so it needs an eager call: a CUDA graph
    replay links every kernel to ``cudaGraphLaunch``. A kernel launched
    through ctypes outside any op would be linked to no event, scopes around
    it or not, and count in ``traced_ms`` alone: every hand-written kernel
    launches inside a dispatcher op of its own for this
    (``ops._cuda_build.CudaKernel``). Empty when the result holds no CUDA
    tensor."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synchronize(fn(*args))
        with scope("device_stage_times"):
            out = fn(*args)
        synchronize(out)
    if not _cuda_devices(out, set()):
        return StageTimes({}, 0.0, 0.0)
    events = prof.events()
    stages, attributed = attribute_kernels(events, "device_stage_times")
    start = min(e.time_range.start for e in events if e.name == "device_stage_times")
    traced = sum(e.time_range.elapsed_us() for e in device_events(events)
                 if e.time_range.start >= start) / 1e3
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


# ---------------------------------------------------------------------------
# the launch registry: every hand-written kernel, for graphs and the tracer
# ---------------------------------------------------------------------------

# every ``ops._cuda_build.CudaKernel`` made, in order (each appends itself):
# what is read of one is its ``name``, ``launches``, ``captured``, ``counter``,
# ``device_counters`` and ``per_capture`` (``CudaKernel``'s docstring)
KERNELS: List = []
# the tracer's stamp writer, ``ops.stamp.stamp(ring, cursor, col, close)``,
# which that module appends when imported (the kernel package imports it)
CLOCK: List[Callable] = []


def kernel_launches() -> Dict[str, int]:
    """Each registered kernel's launches that ran so far, by name: a
    snapshot, whose difference to a later one counts the launches between."""
    out: Dict[str, int] = {}
    for k in KERNELS:
        out[k.name] = out.get(k.name, 0) + k.launches
    return out


class GraphLaunches:
    """The kernel launches one CUDA graph holds, counted by the kernels
    while it is captured, with each kernel's ``per_capture`` context
    entered around the capture::

        with GraphLaunches() as held:
            ...  # capture
        graph.replay()
        held.replayed()  # each kernel's count += its launches in the graph
    """

    def __init__(self) -> None:
        self.per_replay: Dict[object, int] = {}

    def __enter__(self) -> "GraphLaunches":
        self._before = {k: k.captured for k in KERNELS}
        self._contexts = contextlib.ExitStack()
        for k in KERNELS:
            if k.per_capture is not None:
                self._contexts.enter_context(k.per_capture())
        return self

    def __exit__(self, *exc) -> None:
        self._contexts.close()
        self.per_replay = {
            k: k.captured - self._before.get(k, 0)
            for k in KERNELS if k.captured != self._before.get(k, 0)
        }

    def replayed(self, times: int = 1) -> None:
        for k, n in self.per_replay.items():
            k.launches += n * times


# ---------------------------------------------------------------------------
# the tracer: host spans, device stamps, counters
# ---------------------------------------------------------------------------

TRACE_ENV = "MLP_PPO_TORCH_TRACE"
WIDTH = 5  # int64 columns of a ring row: up to 4 stamps, then its sequence number x 8 + kind
SETUP_SPANS = {"capture": "captures", "build": "builds"}  # one-time work, and its counter
STAMP_KERNEL = "stamp_kernel"  # ``ops.stamp``'s kernel, by its name in a profiler trace
# a row's kind, in its last column
KINDS = {"step": 1, "launch": 2, "learner": 3, "replay": 4, "tail": 5}
# counters that ``trace_summary`` reads by update: the launches of the
# kernels registered with these ``counter`` names (the doubles kernel, B2, D2
# and the non-doubles front D3; read as each update opens and closes, and 0
# while a kernel is not loaded), the plain doubles chain's, the plain tail's
# and the plain front's runs on a card (``count``), and D2's rows needed and
# computed (its ``device_counters``)
LAUNCH_COUNTERS = ("dd_kernel_launches", "nd_tail_kernel_launches", "mlp_kernel_launches",
                   "nd_front_kernel_launches")
UPDATE_COUNTERS = ("dd_kernel_launches", "dd_plain", "nd_tail_kernel_launches",
                   "nd_tail_plain", "mlp_kernel_launches", "mlp_rows_needed",
                   "mlp_rows_computed", "nd_front_kernel_launches", "nd_front_plain")


def tracing() -> bool:
    """Whether the tracer records: ``MLP_PPO_TORCH_TRACE`` unset or not ``0``."""
    return os.environ.get(TRACE_ENV, "1") != "0"


class Span:
    """One host span: its name, start and end (``time.perf_counter``
    seconds), the enclosing span's id (-1: none), the update it fell in
    (-1: none) and its attributes."""

    __slots__ = ("id", "name", "start", "end", "parent", "update", "attrs")

    def __init__(self, id_: int, name: str, start: float, parent: int, update: int,
                 attrs: Dict[str, object]) -> None:
        self.id, self.name, self.start, self.end = id_, name, start, start
        self.parent, self.update, self.attrs = parent, update, attrs

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, id={self.id}, "
                f"parent={self.parent}, update={self.update}, {self.attrs})")


class _Ring:
    """The stamp ring of one device: rows int64 [slots, WIDTH], the cursor
    on the device, and the rows launched into it by the host's count (the
    device cursor, once they have run)."""

    def __init__(self, dev: torch.device, slots: int) -> None:
        self.dev = dev
        self.slots = slots
        self.buf = torch.zeros((slots, WIDTH), dtype=torch.int64, device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.launched = 0


class _Row(NamedTuple):
    # "step" (stage starts, then "end"), "launch" or "replay" (one stamp),
    # "learner" or "tail" (begin, end)
    kind: str
    names: Tuple[str, ...]  # the row's stamp columns, in order
    ring: _Ring
    seq: int  # the row's number in its ring; -1 while held by a captured graph


def _device_counters() -> List[Tuple[Tuple[str, str], Tuple[str, ...], torch.Tensor]]:
    """Each registered kernel's device counters: ((kernel, device), their
    names, the int64 tensor)."""
    return [((k.name, dev), k.device_counters[0], t) for k in KERNELS if k.device_counters
            for dev, t in k.device_counters[1]().items()]


class _Update:
    """What one update recorded until it closes."""

    def __init__(self, number: int) -> None:
        self.number = number
        self.rows: List[_Row] = []
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        # each counted kernel's launches at the update's opening
        self.launches = {k: k.launches for k in KERNELS if k.counter}


class Tracer:
    """Host spans, device stamps and counters, kept in memory and bounded
    (``slots`` ring rows a device, the last ``max_updates`` update records,
    the last ``max_spans`` spans); the module's docstring says what each
    holds. One thread drives the step; spans may come from any thread."""

    def __init__(self, slots: int = 1024, max_updates: int = 512,
                 max_spans: int = 16384) -> None:
        self.slots, self.max_updates, self.max_spans = slots, max_updates, max_spans
        self._lock = threading.RLock()
        self._local = threading.local()  # .stack: open span ids; .row: the stamped step's row
        self.reset()

    def reset(self) -> None:
        """Forget every span, row, record and counter (the rings too)."""
        with self._lock:
            self.rings: Dict[str, _Ring] = {}
            self.spans: Deque[Span] = collections.deque(maxlen=self.max_spans)
            self.setup: Deque[Span] = collections.deque(maxlen=4096)
            self.records: Deque[dict] = collections.deque(maxlen=self.max_updates)
            self.counters: Dict[str, int] = collections.Counter()
            self._pending: Deque[tuple] = collections.deque()
            self._open: Optional[_Update] = None
            self._next_update = 0
            self._next_span = 0
            self._captured: Optional[List[_Row]] = None
            # (kernel, device) -> its device counters at the last record read
            # (a reset reads them now)
            self._device_rows: Dict[Tuple[str, str], List[int]] = {
                key: c.tolist() for key, _, c in _device_counters()}

    # ---- spans and counters

    def _stack(self) -> List[int]:
        return self._local.__dict__.setdefault("stack", [])

    def open_span(self, name: str, attrs: Dict[str, object]) -> Span:
        """A span of ``name`` that starts now."""
        start = time.perf_counter()
        stack = self._stack()
        with self._lock:
            sid, self._next_span = self._next_span, self._next_span + 1
            upd = self._open.number if self._open is not None else -1
        sp = Span(sid, name, start, stack[-1] if stack else -1, upd, attrs)
        stack.append(sid)
        return sp

    def close_span(self, sp: Span, end: Optional[float] = None) -> None:
        """End ``sp`` at ``end`` (``perf_counter`` seconds; default now) and keep it."""
        sp.end = time.perf_counter() if end is None else end
        stack = self._stack()
        if stack and stack[-1] == sp.id:
            stack.pop()
        with self._lock:
            self.spans.append(sp)
            if sp.name in SETUP_SPANS:
                self.setup.append(sp)
                self.count(SETUP_SPANS[sp.name])
            if self._open is not None and sp.update == self._open.number:
                self._open.spans.append(sp)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name``, in all and in the open update."""
        with self._lock:
            self.counters[name] += n
            if self._open is not None:
                self._open.counters[name] = self._open.counters.get(name, 0) + n

    # ---- updates

    def new_update(self) -> None:
        """Close the open update and open the next."""
        with self._lock:
            self._close()
            self._current()

    def end_update(self) -> None:
        """Close the open update: its rows' copy to the host is queued."""
        with self._lock:
            self._close()

    def _current(self) -> _Update:
        if self._open is None:
            self._open = _Update(self._next_update)
            self._next_update += 1
        return self._open

    # ---- device stamps

    def _ring(self, dev: torch.device) -> _Ring:
        ring = self.rings.get(str(dev))
        if ring is None:
            ring = self.rings[str(dev)] = _Ring(dev, self.slots)
        return ring

    def _may_stamp(self, dev: torch.device) -> bool:
        """Tracing is on, and a capture in progress is one whose replays
        will be counted (``capturing``): a graph captured by other means
        holds no stamps, so the host's count of rows stays the cursor."""
        if not tracing():
            return False
        capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
        if capturing and (self._captured is None or str(dev) not in self.rings):
            return False  # the ring is made by an eager step first, outside any capture
        return True

    @staticmethod
    def _stamp(ring: _Ring, col: int, kind: Optional[str] = None) -> None:
        """One stamp in column ``col``; ``kind`` closes the row."""
        CLOCK[0](ring.buf, ring.cursor, col, KINDS[kind] if kind else 0)

    def _row_done(self, kind: str, names: Tuple[str, ...], ring: _Ring) -> None:
        """A row whose last (advancing) stamp was just launched: counted
        now, or, inside a capture, at each replay of the graph."""
        with self._lock:
            if self._captured is not None and ring.dev.type == "cuda" \
                    and torch.cuda.is_current_stream_capturing():
                self._captured.append(_Row(kind, names, ring, -1))
                return
            self._current().rows.append(_Row(kind, names, ring, ring.launched))
            ring.launched += 1

    def mark(self, dev: torch.device, kind: str) -> None:
        """A row of one stamp of ``kind`` (``launch``, ``replay``), queued now."""
        if not self._may_stamp(dev):
            return
        ring = self._ring(dev)
        self._stamp(ring, 0, kind)
        self._row_done(kind, (kind,), ring)

    @contextlib.contextmanager
    def pair(self, dev: torch.device, kind: str) -> Iterator[bool]:
        """A row of ``kind`` (``learner``, ``tail``): device stamps at the
        begin and the end of the work inside; yields whether it stamps."""
        on = self._may_stamp(dev)
        if on:
            ring = self._ring(dev)
            self._stamp(ring, 0)
        yield on
        if on:
            self._stamp(ring, 1, kind)
            self._row_done(kind, ("begin", "end"), ring)

    @contextlib.contextmanager
    def step_stamps(self, dev: torch.device, sampled: bool = True) -> Iterator[None]:
        """Stamp the stages (``stage``) of the step run inside, where
        ``sampled``, and its end."""
        if not (sampled and self._may_stamp(dev)):
            yield
            return
        self._local.row = (self._ring(dev), [])
        try:
            yield
        except BaseException:
            self._local.row = None
            raise
        ring, names = self._local.row
        self._local.row = None
        if names:
            self._stamp(ring, len(names), "step")
            self._row_done("step", (*names, "end"), ring)

    def stage_stamp(self, name: str) -> None:
        """Stamp the start of stage ``name`` in the stamped step, if any."""
        row = getattr(self._local, "row", None)
        if row is None:
            return
        ring, names = row
        if len(names) >= WIDTH - 2:
            raise ValueError(f"a stamped step holds at most {WIDTH - 2} stages: {names}, {name}")
        self._stamp(ring, len(names))
        names.append(name)

    @contextlib.contextmanager
    def learner(self, dev: torch.device) -> Iterator[None]:
        """The ``learner`` span, its device stamps at begin and end, then
        the update closes."""
        with scope("learner", span=True), self.pair(dev, "learner") as on:
            yield
        if on:
            self.end_update()

    @contextlib.contextmanager
    def capturing(self) -> Iterator[List[_Row]]:
        """Collect the rows stamped inside a CUDA graph capture: the list
        handed out, for ``replayed`` after each replay."""
        rows: List[_Row] = []
        with self._lock:
            outer, self._captured = self._captured, rows
        try:
            yield rows
        finally:
            with self._lock:
                self._captured = outer

    def replayed(self, rows: List[_Row], times: int = 1) -> None:
        """Count the rows of a graph that was just replayed ``times`` times."""
        if not rows:
            return
        with self._lock:
            upd = self._current()
            for _ in range(times):
                for r in rows:
                    upd.rows.append(r._replace(seq=r.ring.launched))
                    r.ring.launched += 1

    # ---- read-out

    def _close(self) -> None:
        upd, self._open = self._open, None
        if upd is None:
            return
        for name in LAUNCH_COUNTERS:
            upd.counters.setdefault(name, 0)
        for k in KERNELS:
            if k.counter:
                grown = k.launches - upd.launches.get(k, 0)
                upd.counters[k.counter] = upd.counters.get(k.counter, 0) + grown
        if not (upd.rows or upd.spans):
            return
        by_ring: Dict[int, List[_Row]] = {}
        for r in upd.rows:
            by_ring.setdefault(id(r.ring), []).append(r)
        copies, events = [], []
        for rows in by_ring.values():
            ring = rows[0].ring
            hi = rows[-1].seq + 1
            keep = min(hi - rows[0].seq, ring.slots)
            first = hi - keep
            a = first % ring.slots
            parts = [(a, min(keep, ring.slots - a))]
            if parts[0][1] < keep:
                parts.append((0, keep - parts[0][1]))
            cuda = ring.dev.type == "cuda"
            dst = torch.empty((keep, WIDTH), dtype=torch.int64, pin_memory=cuda)
            at = 0
            for lo, n in parts:
                dst[at:at + n].copy_(ring.buf[lo:lo + n], non_blocking=cuda)
                at += n
            # the device's cursor behind every row launched so far, which
            # must be the host's count: a seq column cannot tell an
            # uncounted row apart, since the device then runs ahead
            cursor = torch.empty(1, dtype=torch.int64, pin_memory=cuda)
            cursor.copy_(ring.cursor, non_blocking=cuda)
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(ring.dev))
                events.append(ev)
            copies.append((ring, first, dst, cursor, ring.launched))
        # the kernels' device counters, as they stand when the update's work is done
        rows = []
        for key, names, c in _device_counters():
            cuda = c.is_cuda
            dst = torch.empty(c.shape, dtype=c.dtype, pin_memory=cuda)
            dst.copy_(c, non_blocking=cuda)
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(c.device))
                events.append(ev)
            rows.append((key, names, dst))
        self._pending.append((upd, copies, events, rows))
        while len(self._pending) > 64:  # the device is far behind: keep the newest
            self._pending.popleft()

    def poll(self) -> None:
        """Read the updates whose copies have landed into records."""
        with self._lock:
            self._poll()

    def _poll(self) -> None:
        while self._pending:
            upd, copies, events, rows = self._pending[0]
            if not all(ev.query() for ev in events):
                return
            self._pending.popleft()
            rec = _record(upd, copies)
            # the device counters' growth since the last record read (kept
            # where it grew)
            for key, names, dst in rows:
                now = dst.tolist()
                last = self._device_rows.get(key, [0] * len(now))
                for name, a, b in zip(names, now, last):
                    if a != b:
                        rec["counters"][name] = rec["counters"].get(name, 0) + a - b
                self._device_rows[key] = now
            self.records.append(rec)

    def records_in(self, t0: Optional[float] = None, t1: Optional[float] = None) -> List[dict]:
        with self._lock:
            self._poll()
            recs = list(self.records)
        if t0 is None and t1 is None:
            return recs
        lo = float("-inf") if t0 is None else t0
        hi = float("inf") if t1 is None else t1
        return [r for r in recs if r["rollout"] is not None and lo <= r["rollout"][0] <= hi]


def _record(upd: _Update, copies) -> dict:
    """An update's record from its rows' landed copies (``Tracer``)."""
    data, astray = {}, set()
    for ring, first, dst, cursor, launched in copies:
        if int(cursor) != launched:  # a row the host did not count: none can be placed
            astray.add(id(ring))
        for i, v in enumerate(dst.tolist()):
            data[(id(ring), first + i)] = v
    got = []
    lost = stale = 0
    for r in upd.rows:
        v = data.get((id(r.ring), r.seq))
        if id(r.ring) in astray:
            stale += 1
        elif v is None:
            lost += 1
        elif v[-1] != r.seq * 8 + KINDS[r.kind]:  # not the row the host launched there
            stale += 1
        else:
            got.append((r, v[:len(r.names)]))
    stages, chunks, wait, learner_ms, launch = [], [], None, None, None
    # the chunk being read (its replay stamp, then its stamped step's first
    # and last stamps) and the end of the last chunk's tail
    chunk, last_end = None, None
    for r, ts in got:
        if r.kind == "step":
            stages.append({n: (ts[i + 1] - ts[i]) / 1e6 for i, n in enumerate(r.names[:-1])})
            if launch is not None:
                wait = (ts[0] - launch) / 1e6
            if chunk is not None and len(chunk) == 1:
                chunk += [ts[0], ts[-1]]
        elif r.kind == "learner":
            learner_ms = (ts[1] - ts[0]) / 1e6
        elif r.kind == "replay":
            if chunk is not None:  # the last chunk's tail was not read
                last_end = None
            chunk = [ts[0]]
        elif r.kind == "tail":
            if chunk is not None and len(chunk) == 3:
                start, first, end = chunk
                chunks.append({
                    "gap": None if last_end is None else (start - last_end) / 1e6,
                    "inputs": (first - start) / 1e6, "step": (end - first) / 1e6,
                    "tail": (ts[1] - ts[0]) / 1e6, "span": (ts[1] - start) / 1e6})
            chunk, last_end = None, ts[1]
        launch = ts[0] if r.kind == "launch" else None
    span = {}
    for s in upd.spans:
        span.setdefault(s.name, s)
    replays = [s for s in upd.spans if s.name == "replay"]
    c = dict(upd.counters)
    return {
        "update": upd.number,
        "rollout": (span["rollout"].start, span["rollout"].end) if "rollout" in span else None,
        "learner": (span["learner"].start, span["learner"].end) if "learner" in span else None,
        "stages": stages,
        "chunks": chunks,
        "launch_wait_ms": wait,
        "learner_ms": learner_ms,
        "replay_ms": sum(s.seconds for s in replays) * 1e3,
        "replays": len(replays),
        "captures": c.get("captures", 0),
        "builds": c.get("builds", 0),
        "counters": c,
        "lost_rows": lost,
        "stale_rows": stale,
        "rows": [(r.kind, r.names, ts, str(r.ring.dev)) for r, ts in got],
    }


TRACER = Tracer()


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """A stage of the rollout step: ``scope(name)``, with a device stamp at
    its start where the step is stamped (``step_stamps``)."""
    with scope(name):
        TRACER.stage_stamp(name)
        yield


def step_stamps(dev: torch.device, sampled: bool = True):
    return TRACER.step_stamps(dev, sampled)


def launch_stamp(dev: torch.device) -> None:
    """A stamp before the update's first graph launch (a row of its own)."""
    TRACER.mark(dev, "launch")


def replay_stamp(dev: torch.device) -> None:
    """A stamp before a chunk's input copies (a row of its own)."""
    TRACER.mark(dev, "replay")


def chunk_tail(dev: torch.device):
    """Device stamps around a chunk's tail, after its last step (a row of
    its own)."""
    return TRACER.pair(dev, "tail")


def learner(dev: torch.device):
    return TRACER.learner(dev)


def new_update() -> None:
    TRACER.new_update()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the tracer's counter ``name`` (in all and in the open
    update) while tracing is on."""
    if tracing():
        TRACER.count(name, n)


def read_landed() -> None:
    """Turn the closed updates whose rows have landed on the host into
    records, now, where the host would otherwise wait on the card (the
    rollout calls it once its launches are queued)."""
    TRACER.poll()


def trace_flush() -> None:
    """Close the open update (a rollout with no learner after it), so that
    its record is read once its copy has landed."""
    TRACER.end_update()


def capturing():
    """Collect the stamp rows of a CUDA graph being captured inside (the
    list it yields): ``core.graphs.capture_graph`` holds it around every
    capture."""
    return TRACER.capturing()


def replayed(rows: List[_Row], times: int = 1) -> None:
    """Count the stamp rows of a graph just replayed ``times`` times (the
    list ``capturing`` gave): a replay advances the ring's cursor on the
    device, so each replay of a graph that holds rows must be counted
    (``core.graphs.StampedGraph`` counts its own)."""
    TRACER.replayed(rows, times)


def trace_records(t0: Optional[float] = None, t1: Optional[float] = None) -> List[dict]:
    """Each readable update whose ``rollout`` span starts in [t0, t1]
    (``time.perf_counter`` seconds; every readable update without bounds):
    a dict with ``update``; ``rollout`` and ``learner`` (host start, end);
    ``stages`` (each stamped step's {stage: device ms}); ``chunks`` (each
    chunk whose replay, stamped step and tail rows were read, in device ms:
    ``inputs`` from its replay stamp to its first stage stamp, the input
    copies and any wait for the graph's launch; ``step``, its stamped step;
    ``tail``; ``span``, from its replay stamp to its tail's end; ``gap``,
    from the last chunk's tail to its replay stamp, None for the first);
    ``launch_wait_ms``
    (the first graph stamp less the ``launch`` stamp); ``learner_ms`` (the
    learner's device ms); ``replay_ms`` and ``replays`` (host time of the
    graph launch calls); ``captures``, ``builds`` and the other
    ``counters``; ``lost_rows`` (overwritten before their copy) and
    ``stale_rows`` (a row of another number or kind in its slot, or the
    device's cursor not the host's count when the update closed: a row
    launched and not counted); ``rows`` (kind, column names, stamps,
    device)."""
    return TRACER.records_in(t0, t1)


def trace_spans() -> List[Span]:
    """The set-up spans (``capture``, ``build``), oldest first."""
    with TRACER._lock:
        return list(TRACER.setup)


def trace_summary() -> Dict[str, float]:
    """The newest readable update as ``trace/*`` scalars: the mean device
    ms of each stage of its stamped steps, of its chunks' input copies,
    tails and gaps, the launch wait, the learner's device ms, the replays'
    host ms, its ``UPDATE_COUNTERS``, and the graphs captured and kernels
    built so far."""
    recs = trace_records()
    if not recs:
        return {}
    r = recs[-1]
    out: Dict[str, float] = {}
    for name in dict.fromkeys(n for st in r["stages"] for n in st):
        ms = [st[name] for st in r["stages"] if name in st]
        out[f"trace/{name}_ms"] = sum(ms) / len(ms)
    for part in ("inputs", "tail", "gap"):
        ms = [c[part] for c in r["chunks"] if c[part] is not None]
        if ms:
            out[f"trace/chunk_{part}_ms"] = sum(ms) / len(ms)
    if r["launch_wait_ms"] is not None:
        out["trace/launch_wait_ms"] = r["launch_wait_ms"]
    if r["learner_ms"] is not None:
        out["trace/learner_device_ms"] = r["learner_ms"]
    out["trace/replay_host_ms"] = r["replay_ms"]
    for name in UPDATE_COUNTERS:
        out[f"trace/{name}"] = float(r["counters"].get(name, 0))
    out["trace/captures"] = float(TRACER.counters.get("captures", 0))
    out["trace/builds"] = float(TRACER.counters.get("builds", 0))
    return out


def span_self_seconds(spans: Iterable[Span]) -> Dict[int, float]:
    """Each span's own time: its seconds less its children's (spans whose
    parent it is), by span id."""
    spans = list(spans)
    own = {s.id: s.seconds for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.seconds
    return own


# ---- clocks

def _unix_minus_perf_ns() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, from the
    tightest of five bracketed readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def to_profiler_us(t: float, prof) -> float:
    """Host time ``t`` (``time.perf_counter`` seconds) on the timeline of
    torch.profiler trace ``prof``: microseconds from its trace start, as its
    events' ``time_range`` gives them. Kineto stamps in Unix time (ns); the
    offset from ``perf_counter`` is read now, so a step of the wall clock
    between ``t`` and the call moves the result."""
    start = prof.profiler.kineto_results.trace_start_ns()
    return (t * 1e9 + _unix_minus_perf_ns() - start) / 1e3


def device_offset_us(prof) -> Optional[float]:
    """Microseconds to add to a device stamp (ns / 1e3) to put it on
    ``prof``'s timeline: the traced starts of the stamp kernels against the
    stamps they wrote, in the updates read during the trace (the densest
    2 us cluster of their differences, robust to records the profiler
    drops). None where the trace or the records hold no stamp."""
    evs = [e.time_range.start for e in device_events(prof.events()) if STAMP_KERNEL in e.name]
    if not evs:
        return None
    lo, hi = min(evs), max(evs)
    host = lambda t: to_profiler_us(t, prof)
    stamps = [t / 1e3 for r in trace_records()
              if r["rollout"] is not None and lo - 1e6 <= host(r["rollout"][0]) <= hi + 1e6
              for _, _, ts, dev in r["rows"] if dev.startswith("cuda") for t in ts]
    if not stamps:
        return None
    diffs = [e - s for e in evs for s in stamps]
    bins = collections.Counter(round(d / 2.0) for d in diffs)
    mode = bins.most_common(1)[0][0] * 2.0
    near = sorted(d for d in diffs if abs(d - mode) <= 2.0)
    return near[len(near) // 2]


def device_to_profiler_us(ns: int, prof, offset: Optional[float] = None) -> float:
    """Device stamp ``ns`` on ``prof``'s timeline (``device_offset_us``)."""
    off = device_offset_us(prof) if offset is None else offset
    if off is None:
        raise ValueError("the trace holds no stamp kernel of a readable update")
    return ns / 1e3 + off


def _device_minus_perf_ns(dev: torch.device) -> int:
    """The device clock less ``perf_counter_ns``: a stamp bracketed by
    synchronisations, the tightest of five (the card's clock is not the
    host's). 0 on the CPU, whose stamps are ``perf_counter_ns``. Syncs."""
    if dev.type != "cuda":
        return 0
    buf = torch.zeros((1, WIDTH), dtype=torch.int64, device=dev)
    cur = torch.zeros(1, dtype=torch.int64, device=dev)
    best = None
    for _ in range(5):
        torch.cuda.synchronize(dev)
        a = time.perf_counter_ns()
        CLOCK[0](buf, cur, 0)
        torch.cuda.synchronize(dev)
        b = time.perf_counter_ns()
        t = int(buf[0, 0])
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def chrome_trace() -> dict:
    """Host spans and device stage intervals on one timeline (the host's
    ``perf_counter``, in us) as a Chrome trace (``chrome://tracing``,
    Perfetto). A card's stamps are moved onto the host's clock by a stamp
    bracketed by synchronisations, to within its bracket (tens of us).
    Syncs the devices: not inside a timed window."""
    pid = os.getpid()
    safe = lambda v: v if isinstance(v, (int, float, str, bool)) or v is None else str(v)
    events = [{"name": s.name, "ph": "X", "ts": s.start * 1e6, "dur": s.seconds * 1e6,
               "pid": pid, "tid": "host",
               "args": {"update": s.update, "id": s.id, "parent": s.parent,
                        **{k: safe(v) for k, v in s.attrs.items()}}}
              for s in list(TRACER.spans)]
    recs = trace_records()
    offsets = {d: _device_minus_perf_ns(torch.device(d))
               for d in {dev for r in recs for *_, dev in r["rows"]}}
    for r in recs:
        for kind, names, ts, dev in r["rows"]:
            us = lambda ns: (ns - offsets[dev]) / 1e3
            tid = f"device {dev}"
            base = {"pid": pid, "tid": tid, "args": {"update": r["update"]}}
            if kind == "step":
                for i, n in enumerate(names[:-1]):
                    events.append({"name": n, "ph": "X", "ts": us(ts[i]),
                                   "dur": (ts[i + 1] - ts[i]) / 1e3, **base})
            elif kind in ("learner", "tail"):
                events.append({"name": kind, "ph": "X", "ts": us(ts[0]),
                               "dur": (ts[1] - ts[0]) / 1e3, **base})
            else:
                events.append({"name": kind, "ph": "i", "s": "t", "ts": us(ts[0]), **base})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str) -> None:
    """``chrome_trace()`` written as JSON to ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
