"""Fused board -> value for the deep net (``ModelConfig.wildbg``): D2.

V(board, side-to-move) of wildbg's net, 198 -> 300 -> 250 -> 200 -> 6, ReLU,
softmax over the six outcomes, V = softmax(z) . ``OUTCOME_VALUES``, straight
from int8 boards [..., 52]: the [..., 198] feature tensor is never built.
It replaces no TPU kernel (the JAX package has no such net); it exists
because no other kernel computes this net. Layer 1 takes B1's telescoped
identity at width 300 (``fused_value.telescope_layer1``); the three layers
after it are products of the last activations by bf16 weights.

Rounding points, the same in both implementations: G and the weights of
layers 2-4 in bf16, each hidden layer's activations rounded to bf16 after
the bias and ReLU, every product and sum in f32; the logits, the softmax
and the equity in f32.

* ``mlp_value_plain`` -- plain PyTorch: the CPU path, and on the card the
  kernel's oracle. TF32 must stay off (PyTorch's default for matmuls).
* the CUDA kernel ``csrc/mlp_value.cu`` (sm_90a; every layer on the tensor
  cores by wgmma), built with ``nvcc`` at first use and launched inside the
  dispatcher op ``mlp_ppo_torch::mlp_value`` (``ops/_cuda_build.py``), so
  torch.profiler links it to the scopes around its call. Its weight operand
  is every layer cut into stages of 64 output columns (``STAGES``), each
  laid out as its wgmma descriptor reads it (``pack_weights``), made once
  per parameter set (``fused_value.packed_params``).

``valid`` (optional, bool, the boards' batch shape) marks the rows the
caller needs: only those are valued, the others read 0. The kernel compacts
them on the card, so padded slots cost no products. Each call adds the rows
it was asked to value to ``rows_needed`` and the rows it computed (the
kernel: its tiles of 128 rows, partial ones included) to ``rows_computed``,
two int64 counters on the boards' device (``counters``): the kernel adds
them by atomics, inside CUDA graphs too, and the tracer copies them out
without a wait as each update closes (``KERNEL``'s device counters,
``mlp_rows_needed`` and ``mlp_rows_computed``). ``KERNEL.launches`` counts
the launches that ran, eager and replayed (``mlp_kernel_launches``).
``bound`` is the least time of the function on the rows a step needs;
``utils.cost`` counts a call by it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel, aligned16
from mlp_ppo_2ply_multi_tpu_torch.utils import cost
from mlp_ppo_2ply_multi_tpu_torch.utils.cost import BF16_FLOP_PER_S, HBM_BYTES_PER_S

N_CELLS = fv.N_CELLS
N_REP = fv.N_REP  # 208: layer 1's telescoped depth
WIDTHS = (198, 300, 250, 200, 6)  # the net the kernel is built for
# each layer's (depth K, width N) as the kernel runs it, padded with zero
# weights to whole 16-deep k steps and 64-wide stages (the head to 8)
PADDED = ((N_REP, 320), (320, 256), (256, 256), (256, 8))
STAGE_N = 64  # output columns of a stage (the head's one stage: 8)
TILE = 128  # rows a CTA values at a time: two warpgroups of 64
HEAD_FLOATS = 320 + 320 + 256 + 256 + 8 + 8  # b1', b1' + tflip, b2, b3, b4, u
# how far the kernel may lie from ``mlp_value_plain``, as a share of the
# values' spread (max - min over a batch): both round at the same points,
# but another f32 summation order can move a hidden unit across a bf16
# rounding boundary, and that runs on through the later layers. Each route
# lies within 8 x 2^-9 of the spread of the f32 net (four layers, two bf16
# operands a product). Measured on the CPU: two plain versions that sum in
# other orders 0.12-0.40% of the spread apart, an fp8 forward 22-52%.
SPREAD_TOL = 8 * 2.0**-9


def stages() -> Tuple[Tuple[int, int, int, int], ...]:
    """(layer, first column, K, N) of each weight stage, in the order the
    kernel streams them: 5 of layer 1, 4 of layer 2, 4 of layer 3, the head."""
    out = []
    for layer, (k, n) in enumerate(PADDED):
        w = min(STAGE_N, n)
        out += [(layer, c, k, w) for c in range(0, n, w)]
    return tuple(out)


STAGES = stages()
STAGE_BYTES = tuple(k * n * 2 for _, _, k, n in STAGES)

_SRC = Path(__file__).resolve().parent / "csrc" / "mlp_value.cu"


def check_params(params: Dict[str, torch.Tensor]) -> None:
    """Raise unless ``params`` are the net of ``WIDTHS``."""
    shapes = [tuple(params[f"w{i}"].shape) for i in range(1, 5) if f"w{i}" in params]
    want = [(a, b) for a, b in zip(WIDTHS[:-1], WIDTHS[1:])]
    if shapes != want or "w5" in params:
        raise ValueError(f"the deep value kernel is built for {WIDTHS}; the params' weights "
                         f"are {shapes}")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def layer_operands(params: Dict[str, torch.Tensor]):
    """(G bf16 [208, 300], b1' f32 [300], tflip f32 [300], and (w bf16, b
    f32) of layers 2-4), unpadded: the operands both implementations take."""
    g, b1p, tflip = fv.telescope_layer1(params["w1"], params["b1"])
    rest = [(params[f"w{i}"].float().to(torch.bfloat16), params[f"b{i}"].float())
            for i in (2, 3, 4)]
    return g.to(torch.bfloat16), b1p[0], tflip[0], rest


def mlp_value_plain(boards_data: torch.Tensor, flag, params: Dict[str, torch.Tensor],
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 [...] from int8 [..., 52]
    boards, a side-to-move flag broadcastable to the batch shape and an
    optional ``valid`` mask (0 where it is false). Values every row."""
    fv._check_boards(boards_data)
    check_params(params)
    bs = boards_data.shape[:-1]
    g, b1p, tflip, rest = layer_operands(params)
    ks = torch.arange(4, dtype=torch.float32, device=boards_data.device)
    cnt = boards_data.to(torch.float32)
    r = _round_bf16(torch.clamp(cnt[..., None] - ks, min=0.0).reshape(*bs, N_REP))
    f = torch.broadcast_to(torch.as_tensor(flag, device=r.device), bs)
    bias = torch.where((f == 0)[..., None], b1p, b1p + tflip)
    h = _round_bf16(torch.relu(r @ g.float() + bias))
    for i, (w, b) in enumerate(rest):
        h = h @ w.float() + b
        if i < len(rest) - 1:
            h = _round_bf16(torch.relu(h))
    v = torch.softmax(h, -1) @ value_net.outcome_values(h.device)
    if valid is not None:
        v = torch.where(valid, v, 0.0)
    return v


def pack_weights(params: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's parameter operands: (the weight stages, bf16, flat, in
    ``STAGES`` order, each [K, N] block in the layout of
    ``fused_value.g_index_map(N, K)``; the head f32 [HEAD_FLOATS] = b1',
    b1' + tflip, b2, b3, b4 and the outcomes' values u, each padded with
    zeros to its layer's width)."""
    g, b1p, tflip, rest = layer_operands(params)
    mats = [g] + [w for w, _ in rest]
    dev = g.device
    padded = []
    for m, (k, n) in zip(mats, PADDED):
        z = torch.zeros((k, n), dtype=torch.bfloat16, device=dev)
        z[:m.shape[0], :m.shape[1]] = m
        padded.append(z)
    blocks = [fv.pack_g(padded[layer][:, c:c + n].contiguous()) for layer, c, _, n in STAGES]

    def pad(v, n):
        return torch.cat([v, v.new_zeros(n - v.shape[0])])

    head = torch.cat([pad(b1p, 320), pad(b1p + tflip, 320), pad(rest[0][1], 256),
                      pad(rest[1][1], 256), pad(rest[2][1], 8),
                      pad(value_net.outcome_values(dev), 8)])
    return torch.cat(blocks).contiguous(), head.contiguous()


# device -> int64 [2]: rows needed, rows computed (module docstring)
_COUNTERS: Dict[str, torch.Tensor] = {}


def counters(device) -> torch.Tensor:
    """The int64 [2] counters (rows needed, rows computed) of ``device``,
    made at the first call there. Make that call outside a CUDA graph
    capture: the graph would own the memory and zero it at every replay."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _COUNTERS.get(str(dev))
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("mlp_value's counters are made at a first call outside a capture")
        t = _COUNTERS[str(dev)] = torch.zeros(2, dtype=torch.int64, device=dev)
    return t


def counter_tensors() -> Dict[str, torch.Tensor]:
    """Every device's counters made so far, by device name."""
    return dict(_COUNTERS)


def _bind(lib: ctypes.CDLL) -> None:
    lib.mlp_value_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p]
    lib.mlp_value_launch.restype = ctypes.c_int
    lib.mlp_value_smem.argtypes = []
    lib.mlp_value_smem.restype = ctypes.c_int
    lib.mlp_value_weight_bytes.argtypes = []
    lib.mlp_value_weight_bytes.restype = ctypes.c_longlong
    if lib.mlp_value_weight_bytes() != sum(STAGE_BYTES):
        raise RuntimeError(f"mlp_value.cu streams {lib.mlp_value_weight_bytes()} weight bytes, "
                           f"the packing makes {sum(STAGE_BYTES)}")


KERNEL = CudaKernel(
    _SRC, _bind,
    "(Tensor boards, Tensor flag, Tensor valid, Tensor wpack, Tensor head, Tensor(a!) out, "
    "Tensor(b!) count, bool has_valid) -> ()",
    lambda boards, flag, valid, wpack, head, out, count, has_valid: (
        boards.data_ptr(), flag.data_ptr(), valid.data_ptr() if has_valid else None,
        wpack.data_ptr(), head.data_ptr(), out.data_ptr(), count.data_ptr(),
        boards.numel() // N_CELLS),
    counter="mlp_kernel_launches",
    device_counters=(("mlp_rows_needed", "mlp_rows_computed"), counter_tensors))


def kernel_operands(boards_data, flag, params, valid=None):
    """Check what the CUDA kernel takes and lay out its operands: (boards
    int8 [n, 52], flag int8 [n], valid bool [n] or None, weight stages,
    head), on the boards' device, contiguous and 16-byte aligned."""
    fv._check_boards(boards_data)
    check_params(params)
    dev = boards_data.device
    if dev.type != "cuda":
        raise ValueError(f"the mlp_value kernel runs on cuda, boards are on {dev}")
    for name, t in params.items():
        if t.device != dev:
            raise ValueError(f"param {name} is on {t.device}, boards on {dev}")
    bs = boards_data.shape[:-1]
    wpack, head = fv.packed_params(params, pack_weights)
    f = torch.broadcast_to(torch.as_tensor(flag, device=dev), bs).to(torch.int8)
    v = None
    if valid is not None:
        v = aligned16(torch.broadcast_to(valid, bs).to(torch.bool).reshape(-1))
    return (aligned16(boards_data.reshape(-1, N_CELLS)), aligned16(f.reshape(-1)), v, wpack,
            head)


def launch_kernel(boards, f, valid, wpack, head) -> torch.Tensor:
    """Launch the CUDA kernel on operands from ``kernel_operands`` on the
    current stream, inside the op ``mlp_ppo_torch::mlp_value``; f32 [n]
    out. Counts the launch."""
    n = boards.shape[0]
    dev = boards.device
    ok = (boards.is_cuda and boards.dtype == torch.int8 and boards.dim() == 2
          and boards.shape[1] == N_CELLS and f.dtype == torch.int8 and f.numel() == n
          and (valid is None or (valid.dtype == torch.bool and valid.numel() == n))
          and wpack.numel() * 2 == sum(STAGE_BYTES) and head.numel() == HEAD_FLOATS
          and all(t.device == dev and t.is_contiguous() and t.data_ptr() % 16 == 0
                  for t in (boards, f, wpack, head) + (() if valid is None else (valid,))))
    if not ok:
        raise ValueError("launch_kernel takes operands from kernel_operands")
    count = counters(dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    KERNEL.launch(boards, f, f if valid is None else valid, wpack, head, out, count,
                  valid is not None)
    return out


def flops_per_row() -> float:
    """The net's forward operations a row: two a multiply-add of its four
    products, unpadded (371,200)."""
    return 2.0 * sum(a * b for a, b in zip(WIDTHS[:-1], WIDTHS[1:]))


def weight_bytes() -> int:
    """The bf16 weights of the four products, unpadded."""
    return 2 * sum(a * b for a, b in zip(WIDTHS[:-1], WIDTHS[1:]))


def bound(rows: float, launches: int = 1) -> Dict[str, object]:
    """Least time for the function on ``rows`` needed rows in ``launches``
    calls: bytes (board, flag, valid byte and f32 value a row; the bf16
    weights once a call) over HBM bandwidth, or the net's forward
    operations a row (``flops_per_row``) over the bf16 peak. A formula of
    the counts alone: it reads no data."""
    nbytes = rows * (N_CELLS + 1 + 1 + 4) + launches * weight_bytes()
    ops = rows * flops_per_row()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return dict(rows=rows, bytes=nbytes, ops=ops, bytes_ms=t_bytes, ops_ms=t_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _count(boards: torch.Tensor, valid) -> Dict[str, float]:
    """One call's count for ``utils.cost``: the operations and bytes of its
    needed rows (reads the mask: not inside a capture)."""
    n = boards.numel() // N_CELLS
    rows = n if valid is None else int(torch.broadcast_to(valid, boards.shape[:-1]).sum())
    b = bound(rows)
    return {"flops": b["ops"], "bytes": b["bytes"]}


def mlp_value(boards_data: torch.Tensor, flag, params: Dict[str, torch.Tensor],
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """V(board, side-to-move) of the deep net for any batch shape: f32 [...]
    from int8 [..., 52] boards, a flag broadcastable to [...] and an
    optional ``valid`` mask (0 where false). A CPU tensor goes to
    ``mlp_value_plain`` (the counters follow it), a CUDA tensor to the
    kernel; anything else raises."""
    fv._check_boards(boards_data)
    kind = boards_data.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"mlp_value cannot run on device {boards_data.device}")
    bs = boards_data.shape[:-1]
    with cost.kernel("mlp_value_kernel", lambda: _count(boards_data, valid)):
        if kind == "cpu":
            c = counters(boards_data.device)
            n = boards_data.numel() // N_CELLS
            c[0] += n if valid is None else torch.broadcast_to(valid, bs).sum()
            c[1] += n
            return mlp_value_plain(boards_data, flag, params, valid)
        return launch_kernel(*kernel_operands(boards_data, flag, params, valid)).reshape(bs)
