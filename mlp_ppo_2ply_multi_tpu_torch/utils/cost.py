"""Operations and bytes of one eager call, by stage: the counterpart of
XLA's ``compile().cost_analysis()``, which JAX's ``bench.py`` and
``scripts/roofline.py`` read.

``step_cost(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode``
and counts, for every aten op it dispatches:

* ``flops``: the matmul family, by ``torch.utils.flop_counter``'s formulas;
* ``elementwise_ops``: one per output element of every other compute op
  (views, allocations, copies, fills and gathers compute nothing);
* ``bytes``: the op's inputs read once and its outputs written once (a
  broadcast input counts its distinct elements); a view moves none.

A host read (``.item()``) is not device work, nor is the 0-d result it
reads: PyTorch's CPU kernels make such reads as argument checks
(``one_hot``'s bounds) where its CUDA kernels check nothing, and the port's
steps read nothing to the host on the card.

The port's CUDA kernels are launched through ``ctypes``, which no dispatch
mode sees. Their wrappers run inside ``kernel``: while a counter is active
it adds the kernel's own count (its bound's formula, beside the wrapper)
and counts none of the ops inside, neither the plain route's on the CPU nor
the operand layout on the card. One step then counts the same on the CPU as
on the card. The formulas read the data, so counting runs on an eager call,
never inside a CUDA graph capture (the graph replays the same ops).

The peaks are NVIDIA's data sheet for one H100 SXM (dense rates, no
sparsity) at its 700 W power limit.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from mlp_ppo_2ply_multi_tpu_torch.utils.profiling import scopes, stage_tag

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# CUDA-core operations (integer and f32, outside the tensor cores): the data
# sheet's 67 TFLOP/s f32 rate
CORE_OPS_PER_S = 67e12
# MUFU (ex2, rcp): 16 a clock per SM, 132 SMs at the 1,980 MHz boost clock
MUFU_OPS_PER_S = 16 * 132 * 1.98e9

COUNTS = ("flops", "elementwise_ops", "bytes", "ops")

# ops that allocate without touching memory, or that alias their input
_NO_WORK = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
            "resize_", "_unsafe_view", "alias", "detach", "lift_fresh", "_reshape_alias"}
# ops that move or fill data and compute nothing: bytes, no elementwise ops
_MOVES = {"copy_", "_to_copy", "clone", "cat", "stack", "constant_pad_nd", "index",
          "index_select", "gather", "take", "fill_", "zero_", "zeros", "ones", "full",
          "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
          "scalar_tensor", "lift_fresh_copy", "repeat", "expand_copy", "index_put_",
          "index_put", "scatter", "scatter_"}

_ACTIVE: Optional["CostCounter"] = None  # the counter counting now, if any


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor spans: a stride-0
    (broadcast) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts every aten op dispatched inside it under the stage tag of the
    scopes open at the time (``profiling.stage_tag``; the op's name where
    none matches). ``by_tag[tag]`` holds the four ``COUNTS``; ``ops`` is
    the number of ops (or kernel launches) counted."""

    def __init__(self) -> None:
        super().__init__()
        self.by_tag: Dict[str, Dict[str, float]] = collections.defaultdict(
            lambda: dict.fromkeys(COUNTS, 0.0))
        self._paused = 0
        # data_ptr of a recent 0-d result -> [tag, its op's counts, uncounted]
        self._scalars: Dict[int, list] = {}

    def add(self, tag: str, **counts: float) -> None:
        row = self.by_tag[tag]
        for k, v in counts.items():
            row[k] += v

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.namespace != "aten":
            return out
        name = func.overloadpacket.__name__
        if getattr(func, "is_view", False) or name in _NO_WORK:
            return out
        if name == "_local_scalar_dense":  # a host read: uncount what made its value
            made = self._scalars.pop(args[0].data_ptr(), None)
            if made is not None and not made[2]:
                self.add(made[0], **{k: -v for k, v in made[1].items()})
                made[2] = True
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        counts = {"bytes": sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)), "ops": 1}
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            counts["flops"] = formula(*args, **kwargs, out_val=out)
        elif name not in _MOVES:
            counts["elementwise_ops"] = sum(t.numel() for t in outs)
        tag = stage_tag(scopes(), f"aten::{name}")
        self.add(tag, **counts)
        if outs and all(t.dim() == 0 for t in outs):
            made = [tag, counts, False]
            for t in outs:
                self._scalars[t.data_ptr()] = made
            while len(self._scalars) > 64:
                del self._scalars[next(iter(self._scalars))]
        return out


@contextlib.contextmanager
def kernel(name: str, count: Callable[[], Dict[str, float]]) -> Iterator[None]:
    """Around a kernel wrapper's route. While a ``CostCounter`` counts, adds
    ``count()`` (a dict of ``flops``, ``elementwise_ops`` and ``bytes``: the
    kernel's formula on these inputs, itself not counted) as one launch of
    ``name`` under the current stage tag, and counts none of the ops inside.
    Else it does nothing."""
    counter = _ACTIVE
    if counter is None:
        yield
        return
    with counter.paused():
        counts = count()
        tag = stage_tag(scopes(), name)
        yield
    counter.add(tag, ops=1, **counts)


class StepCost(NamedTuple):
    """The counts of one call, in total and by stage tag."""

    flops: float
    elementwise_ops: float
    bytes: float
    by_tag: Dict[str, Dict[str, float]]  # tag -> the four COUNTS, most bytes first
    out: Any  # what the call returned


def step_cost(fn: Callable, *args) -> StepCost:
    """Run ``fn(*args)`` once, eagerly, and count its work (module
    docstring). Raises inside a CUDA graph capture or inside another
    count."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("step_cost does not nest")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("step_cost counts an eager call, not a CUDA graph capture")
    counter = CostCounter()
    _ACTIVE = counter
    try:
        with counter:
            out = fn(*args)
    finally:
        _ACTIVE = None
    by_tag = dict(sorted(((t, dict(c)) for t, c in counter.by_tag.items() if any(c.values())),
                         key=lambda kv: -kv[1]["bytes"]))
    total = {k: sum(c[k] for c in by_tag.values()) for k in COUNTS}
    return StepCost(total["flops"], total["elementwise_ops"], total["bytes"], by_tag, out)


def roofline(flops: float, nbytes: float, seconds: float) -> Dict[str, float]:
    """Achieved rates of ``flops`` and ``nbytes`` done in ``seconds``, and
    their fractions of the H100's published bf16 and HBM peaks."""
    tflops = flops / seconds / 1e12
    gbs = nbytes / seconds / 1e9
    return {
        "arithmetic_intensity_flop_per_byte": flops / nbytes if nbytes else 0.0,
        "achieved_tflops": tflops,
        "achieved_gbs": gbs,
        "mfu_vs_datasheet": tflops * 1e12 / BF16_FLOP_PER_S,
        "bw_frac_vs_datasheet": gbs * 1e9 / HBM_BYTES_PER_S,
    }
