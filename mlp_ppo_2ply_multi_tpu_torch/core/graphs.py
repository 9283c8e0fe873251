"""CUDA graphs of a chunk of steps: the capture, and the one cache of
captured graphs that the rollout (``actor.rollout.ChunkGraph``) and the
arena (``eval.arena.MatchGraph``) share, so their graphs' memory pools are
bounded together (``GRAPH_SETS``)."""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterator, Sequence, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.utils import profiling


@contextlib.contextmanager
def syncs_raise() -> Iterator[None]:
    """Make an op that synchronises the host with the card raise, naming
    itself in the traceback, instead of breaking a capture."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


_STREAMS: Dict[str, torch.cuda.Stream] = {}  # device -> capture stream


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream graphs on ``dev`` are warmed up and captured on."""
    if str(dev) not in _STREAMS:
        _STREAMS[str(dev)] = torch.cuda.Stream(dev)
    return _STREAMS[str(dev)]


class StampedGraph(torch.cuda.CUDAGraph):
    """A CUDA graph whose every replay counts the tracer's stamp rows
    captured in it (``profiling.replayed``): a replay moves the stamp ring's
    cursor on the device, whoever calls it, and the host's count of rows
    has to follow it (a timing loop's bare ``graph.replay()`` included)."""

    stamps: Sequence = ()  # the rows ``profiling.capturing`` collected in the capture

    def replay(self) -> None:
        super().replay()
        profiling.replayed(self.stamps)


def capture_graph(body: Callable[[], None], dev: torch.device, what: str
                  ) -> Tuple[torch.cuda.CUDAGraph, profiling.GraphLaunches, Dict[str, object]]:
    """``body`` captured as one CUDA graph on the device's capture stream,
    with every synchronising op made to raise and each kernel's
    ``per_capture`` context entered (``GraphLaunches``: fused_value's
    operands packed once). Run a warm-up of the same
    work on that stream first. Returns (graph, the kernel launches it holds,
    info: the capture + instantiate seconds, the bytes its memory pool
    holds and the launches a replay makes by kernel). A failed capture
    raises, naming ``what``. The tracer keeps it as a ``capture`` span with
    the seconds and the pool's reserved bytes, and the graph counts the
    tracer's stamp rows it holds at each replay (``StampedGraph``)."""
    with profiling.scope("capture", span=True, what=what) as attrs:
        stream = capture_stream(dev)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_stats(dev)
        t0 = time.perf_counter()
        graph = StampedGraph()
        launches = profiling.GraphLaunches()
        try:
            with launches, profiling.capturing() as graph.stamps, \
                    torch.cuda.graph(graph, stream=stream):
                with syncs_raise():
                    body()
        except RuntimeError as e:
            if isinstance(e, NotImplementedError):
                raise
            raise RuntimeError(f"capturing {what} as a CUDA graph failed: {e}") from e
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        torch.cuda.empty_cache()
        mem1 = torch.cuda.memory_stats(dev)
        delta = lambda k: mem1.get(k, 0) - mem0.get(k, 0)
        info = dict(
            capture_s=seconds,
            pool_reserved_bytes=delta("reserved_bytes.all.current"),
            pool_allocated_bytes=delta("allocated_bytes.all.current"),
            launches_per_replay={k.name: n for k, n in launches.per_replay.items()},
        )
        attrs.update(capture_s=info["capture_s"], pool_reserved_bytes=info["pool_reserved_bytes"])
    return graph, launches, info


def params_signature(params) -> tuple:
    """What a graph key holds of a params dict. A graph reads the params
    where they were when it was captured: the signature holds each tensor's
    storage address, shape, strides and dtype, so params moved to another
    storage (a restored checkpoint, a new dict) are captured anew, while an
    in-place update (the optimizer's step) is read by the next replay."""
    return tuple((k, params[k].data_ptr(), tuple(params[k].shape), params[k].stride(),
                  params[k].dtype) for k in sorted(params))


GRAPH_SETS = 4  # captured graphs kept, rollout's and arena's together
GRAPHS: "OrderedDict[tuple, object]" = OrderedDict()  # key -> graph, least recent first
captures = 0  # graphs that cached_graph has captured in this process


def cached_graph(key: tuple, make: Callable[[], object]) -> Tuple[object, bool]:
    """The graph kept under ``key``, or ``make()``'s, kept from now on; it
    becomes the most recently used, and the least recently used beyond
    ``GRAPH_SETS`` are dropped with their memory pools. Returns (graph,
    whether ``make`` captured it in this call); each capture adds one to
    ``captures``."""
    global captures
    g = GRAPHS.get(key)
    made = g is None
    if made:
        g = GRAPHS[key] = make()
        captures += 1
        while len(GRAPHS) > GRAPH_SETS:
            GRAPHS.popitem(last=False)
    GRAPHS.move_to_end(key)
    return g, made


def clear_graphs() -> None:
    """Drop every captured graph and its memory pool."""
    GRAPHS.clear()
