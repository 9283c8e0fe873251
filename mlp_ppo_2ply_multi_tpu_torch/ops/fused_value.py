"""Fused board -> value: V(board, side-to-move) straight from int8 boards.

Port of ``mlp_ppo_2ply_multi_tpu/ops/fused_value.py``. The first layer uses
the exact telescoping identity of the Tesauro encoding: for integer counts n,

    [n>=1] = relu(n) - relu(n-1), [n>=2] = relu(n-1) - relu(n-2),
    [n>=3] = relu(n-2) - relu(n-3), max(n-3, 0)/2 = relu(n-3)/2

so ``features @ W1 == relu(cnt @ REP - K) @ G`` with G [208, h] recombined
from W1 (``recombine_params``), and the side-to-move one-hot enters layer 1
linearly (``b1' + f * tflip``). The [..., 198] feature tensor is never built.

Two implementations of one function, with the TPU kernel's rounding points
(G, the hidden activations and w2 in bf16; every product and sum in f32):

* ``fused_value_plain`` — plain PyTorch. The CPU path, and on the card the
  kernel's oracle. Its matmuls run in full f32: TF32 must stay off
  (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
* the CUDA kernel ``csrc/fused_value.cu`` (sm_90a; layer 1 on the tensor
  cores by wgmma), built with ``nvcc`` at first use (``ops/_cuda_build.py``)
  and bound with ``ctypes``. Its parameter operands (G in the layout its
  shared-memory descriptor reads, ``pack_g``/``g_index_map``, and the
  bias/head vector) are made once per parameter set (``packed_params``).

``fused_value`` routes a CPU tensor to the plain version and a CUDA tensor
to the kernel, and raises on anything else.

Under a CUDA graph capture the packed operands are made from the live
parameter tensors by captured ops (``packed_params``), so every replay
repacks and a replay after an in-place optimizer step reads the new
weights; each launch counts once per replay (``CudaKernel.count_launch``).
"""
from __future__ import annotations

import contextlib
import ctypes
import weakref
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.device import device_constant
from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel, aligned16

N_CELLS = 52  # 48 point cells + bar x2 + off x2 (engine/board.py layout)
N_REP = 4 * N_CELLS  # 208
HIDDEN = 128  # kHidden in csrc/fused_value.cu

_SRC = Path(__file__).resolve().parent / "csrc" / "fused_value.cu"


def recombine_params(params: Dict[str, torch.Tensor], dtype=torch.bfloat16):
    """(G [208, h], b1' [1, h], tflip [1, h], w2 [1, h], b2 [1]) from the
    value-net params, with the JAX package's algebra and rounding points:
    G and w2 rounded to ``dtype``, b1', tflip and b2 kept in f32."""
    w1 = params["w1"].float()  # [198, h]
    h = w1.shape[1]
    g = torch.zeros((N_REP, h), dtype=torch.float32, device=w1.device)
    w0, w1_, w2_, w3_ = (w1[k:192:4] for k in range(4))  # [48, h] each
    g[0:192:4] = w0
    g[1:192:4] = w1_ - w0
    g[2:192:4] = w2_ - w1_
    g[3:192:4] = 0.5 * w3_ - w2_
    # board tail [48]=bar p0, [49]=bar p1, [50]=off p0, [51]=off p1; feature
    # rows 192=bar0/2, 193=off0/15, 194=bar1/2, 195=off1/15
    g[4 * 48] = w1[192] / 2.0
    g[4 * 49] = w1[194] / 2.0
    g[4 * 50] = w1[193] / 15.0
    g[4 * 51] = w1[195] / 15.0
    # turn one-hot: w196*(1-f) + w197*f = (b1 + w196) + f*(w197 - w196)
    b1p = (params["b1"].float() + w1[196])[None, :]
    tflip = (w1[197] - w1[196])[None, :]
    w2r = params["w2"].float().reshape(1, h)
    return g.to(dtype), b1p, tflip, w2r.to(dtype), params["b2"].float().reshape(1)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _check_boards(boards_data: torch.Tensor) -> None:
    if not isinstance(boards_data, torch.Tensor):
        raise TypeError("boards_data must be a torch.Tensor")
    if boards_data.dtype != torch.int8 or boards_data.shape[-1:] != (N_CELLS,):
        raise ValueError(
            f"boards_data must be int8 [..., {N_CELLS}], got "
            f"{boards_data.dtype} {tuple(boards_data.shape)}"
        )


def fused_value_plain(
    boards_data: torch.Tensor, flag: torch.Tensor, params: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 [...] from int8 [..., 52]
    boards and a side-to-move flag broadcastable to the batch shape."""
    _check_boards(boards_data)
    bs = boards_data.shape[:-1]
    g, b1p, tflip, w2r, b2 = recombine_params(params)
    ks = torch.arange(4, dtype=torch.float32, device=boards_data.device)
    cnt = boards_data.to(torch.float32)
    r = _round_bf16(torch.clamp(cnt[..., None] - ks, min=0.0).reshape(*bs, N_REP))
    z = r @ g.float()  # [..., h]
    f = torch.broadcast_to(torch.as_tensor(flag, device=z.device), bs)
    bias = torch.where((f == 0)[..., None], b1p, b1p + tflip)
    hid = _round_bf16(torch.sigmoid(z + bias))
    return (hid @ w2r.float().T)[..., 0] + b2


def _bind(lib: ctypes.CDLL) -> None:
    lib.fused_value_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.fused_value_launch.restype = ctypes.c_int
    lib.fused_value_hidden.argtypes = []
    lib.fused_value_hidden.restype = ctypes.c_int
    lib.fused_value_smem.argtypes = []
    lib.fused_value_smem.restype = ctypes.c_int
    if lib.fused_value_hidden() != HIDDEN:
        raise RuntimeError(f"fused_value.cu is built for hidden={lib.fused_value_hidden()}")


KERNEL = CudaKernel(_SRC, _bind)


def g_index_map(hidden: int = HIDDEN) -> torch.Tensor:
    """int64 [208 * hidden]: entry i is the flat index into G [208, hidden]
    of the i-th bf16 of the packed G, in the order the kernel reads it.

    The kernel's wgmma reads G one k step of 16 rows at a time, K-major
    without swizzle: 8 x 8 "core matrices" (8 hidden units n, 8 k, k
    contiguous) of 128 contiguous bytes. The packed order is
    [s, i, j, r, e] for k = 16s + 8j + e and n = 8i + r: core matrices 128 B
    apart along K (j) and 256 B apart along N (i), each k step 4,096 B."""
    s = torch.arange(N_REP // 16).view(-1, 1, 1, 1, 1)
    i = torch.arange(hidden // 8).view(1, -1, 1, 1, 1)
    j = torch.arange(2).view(1, 1, -1, 1, 1)
    r = torch.arange(8).view(1, 1, 1, -1, 1)
    e = torch.arange(8).view(1, 1, 1, 1, -1)
    k = 16 * s + 8 * j + e
    n = 8 * i + r
    return (k * hidden + n).reshape(-1)


def g_index(hidden: int, device: torch.device) -> torch.Tensor:
    """``g_index_map(hidden)`` on ``device``, made once per device."""
    return device_constant(f"fused_value.g_index.{hidden}", g_index_map(hidden), device)


def pack_g(g: torch.Tensor) -> torch.Tensor:
    """G [208, h] laid out as the kernel reads it (``g_index_map``): a flat
    contiguous tensor of G's dtype."""
    return g.reshape(-1)[g_index(g.shape[1], g.device)].contiguous()


def pack_params(params: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's parameter operands: (packed G bf16 [208 * h], head f32
    [3h + 1] = b1', b1' + tflip, w2, b2). b1' + tflip is the sum the plain
    version adds for flag 1, w2 is its bf16 value as f32."""
    g, b1p, tflip, w2r, b2 = recombine_params(params)
    head = torch.cat([b1p[0], (b1p + tflip)[0], w2r.float()[0], b2])
    return pack_g(g), head.contiguous()


# parameter set (ids of its tensors) -> (weakrefs, versions, operands), the
# most recently used last
_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
PACKED_SETS = 4  # parameter sets kept: a learner's params and actor snapshots
# inside ``packing_once_per_capture``: parameter set -> operands packed by
# captured ops; None outside it
_CAPTURE_PACKED: Optional[Dict[tuple, Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def packing_once_per_capture() -> Iterator[None]:
    """Around a CUDA graph capture: each parameter set is packed by captured
    ops at its first ``packed_params`` call in the capture, and the later
    calls of the same capture reuse those operands."""
    global _CAPTURE_PACKED
    _CAPTURE_PACKED = {}
    try:
        yield
    finally:
        _CAPTURE_PACKED = None


def packed_params(params: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pack_params`` once per parameter set: cached per set of params
    tensors (the ``PACKED_SETS`` most recently used) and checked against
    each tensor's ``_version``.

    Contract: params change only through the tensors themselves. An
    in-place op on them (an optimizer's step, ``add_``, ``copy_`` under
    ``no_grad``) bumps ``_version`` and the next call repacks; a new
    parameter dict is a new set. A write through ``.data`` or ``set_``
    bumps no version, and the kernel would go on using the old operands.

    Under a CUDA graph capture the cache is not used: the operands are
    packed by captured ops (once per capture inside
    ``packing_once_per_capture``, else at every call), so each replay packs
    the params' values at that moment."""
    ts = [params[k] for k in ("w1", "b1", "w2", "b2")]
    key = tuple(id(t) for t in ts)
    if ts[0].is_cuda and torch.cuda.is_current_stream_capturing():
        if _CAPTURE_PACKED is None:
            return pack_params(params)
        if key not in _CAPTURE_PACKED:
            _CAPTURE_PACKED[key] = pack_params(params)
        return _CAPTURE_PACKED[key]
    hit = _PACKED.get(key)
    if hit is not None:
        refs, versions, ops = hit
        if all(r() is t for r, t in zip(refs, ts)) and versions == [t._version for t in ts]:
            _PACKED.move_to_end(key)
            return ops
    ops = pack_params(params)
    _PACKED[key] = ([weakref.ref(t) for t in ts], [t._version for t in ts], ops)
    _PACKED.move_to_end(key)
    while len(_PACKED) > PACKED_SETS:
        _PACKED.popitem(last=False)
    return ops


def kernel_operands(boards_data, flag, params) -> Tuple[torch.Tensor, ...]:
    """Check what the CUDA kernel takes and lay out its operands:
    (boards, flag int8 [...], packed G, head), all on the boards' device,
    contiguous and 16-byte aligned. Raises on anything the kernel does not
    take."""
    _check_boards(boards_data)
    dev = boards_data.device
    if dev.type != "cuda":
        raise ValueError(f"the fused_value kernel runs on cuda, boards are on {dev}")
    if not boards_data.is_contiguous():
        raise ValueError("fused_value kernel needs contiguous boards")
    for name, t in params.items():
        if t.device != dev:
            raise ValueError(f"param {name} is on {t.device}, boards on {dev}")
    if params["w1"].shape[1] != HIDDEN:
        raise ValueError(
            f"fused_value kernel is built for hidden={HIDDEN}, params have "
            f"{params['w1'].shape[1]}"
        )
    gpack, head = packed_params(params)
    f = torch.broadcast_to(torch.as_tensor(flag, device=dev), boards_data.shape[:-1])
    return aligned16(boards_data), aligned16(f.to(torch.int8)), gpack, head


def launch_kernel(boards, f, gpack, head) -> torch.Tensor:
    """Launch the CUDA kernel on operands from ``kernel_operands`` on the
    current stream; f32 [...] out. Counts the launch
    (``CudaKernel.count_launch``: inside a CUDA graph capture it counts
    once per replay)."""
    n = boards.numel() // N_CELLS
    ok = (
        boards.is_cuda and boards.dtype == torch.int8 and f.dtype == torch.int8
        and f.numel() == n and gpack.numel() == N_REP * HIDDEN
        and head.numel() == 3 * HIDDEN + 1
        and all(t.device == boards.device and t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in (boards, f, gpack, head))
    )
    if not ok:
        raise ValueError("launch_kernel takes operands from kernel_operands")
    lib = KERNEL.load()
    out = torch.empty(boards.shape[:-1], dtype=torch.float32, device=boards.device)
    if n == 0:
        return out
    # The launch is asynchronous: temporaries of the caller may be freed when
    # this returns, which is safe because the caching allocator reuses their
    # memory only in order on this same stream.
    with torch.cuda.device(boards.device):
        stream = torch.cuda.current_stream(boards.device).cuda_stream
        rc = lib.fused_value_launch(
            boards.data_ptr(), f.data_ptr(), gpack.data_ptr(), head.data_ptr(),
            out.data_ptr(), n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_value kernel launch failed: CUDA error {rc}")
    KERNEL.count_launch()
    return out


def fused_value(
    boards_data: torch.Tensor, flag: torch.Tensor, params: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """V(board, side-to-move) for any batch shape: f32 [...] from int8
    [..., 52] boards and a flag broadcastable to [...]. Equivalent to
    ``value_net.forward(params, encode_board(boards, flag), cfg)`` in bf16.

    A CPU tensor goes to ``fused_value_plain``; a CUDA tensor to the CUDA
    kernel (which raises if it cannot build or launch); anything else
    raises."""
    _check_boards(boards_data)
    kind = boards_data.device.type
    if kind == "cpu":
        return fused_value_plain(boards_data, flag, params)
    if kind == "cuda":
        return launch_kernel(*kernel_operands(boards_data, flag, params))
    raise ValueError(f"fused_value cannot run on device {boards_data.device}")
