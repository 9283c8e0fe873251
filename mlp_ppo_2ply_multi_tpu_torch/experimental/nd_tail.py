"""The fused non-doubles tail: select, child take, second-submove apply,
delta signature, first-occurrence dedup, max-submove filter and Q7 cap in
one kernel.

Port of ``mlp_ppo_2ply_multi_tpu/experimental/nd_tail.py`` (the Pallas
kernel built by ``_make_kernel``). It runs every pass of the non-doubles
tail that dedups by signature (``movegen2._tier_tail``): the single
full-width pass of the 2-ply scorer's reply enumeration (15 calls a 2-ply
step), and both tiers of the two-tier tail (``movegen2._nd_two_tier``: two
calls a step of the 1-ply split planes and of the 2-ply step's own moves at
``fast()`` widths). JAX chose it with ``MoveGenConfig.nd_tail_kernel``, off
by default because on the TPU the kernel lost to XLA (16-row tiles forced by
scoped VMEM), and only for the single pass; that says nothing about this
card, and the port takes the kernel whatever the flag says.

Two implementations of one function, bit-identical:

* ``nd_tail_plain`` — plain PyTorch (``movegen2._nd_tail``), the CPU path
  and on the card the kernel's oracle;
* the CUDA kernel ``csrc/nd_tail.cu`` (sm_90a), built with ``nvcc`` at first
  use (``ops/_cuda_build.py``), bound with ``ctypes`` and launched inside
  the dispatcher op ``mlp_ppo_torch::nd_tail``, so that a profile links its
  device time to the scopes around the call.

``nd_tail_fused`` routes a CPU tensor to the plain version and a CUDA tensor
to the kernel, and raises on anything else: the kernel takes widths up to
``MAX_K``, and no route falls back to the plain version on a card.
``KERNEL.launches`` counts the
launches that ran, eager and replayed in graphs; the tracer reads it as each
update opens and closes (``nd_tail_kernel_launches``), and counts the plain
version's calls on a card with the Gram dedup's plain tail
(``nd_tail_plain``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen2 import _nd_tail
from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel, aligned16
from mlp_ppo_2ply_multi_tpu_torch.utils import cost, profiling
from mlp_ppo_2ply_multi_tpu_torch.utils.cost import CORE_OPS_PER_S, HBM_BYTES_PER_S

N_SLOTS = 27
N_CAND = 2 * (N_SLOTS + 1) * N_SLOTS  # 1512
N_CELLS = 52

MAX_K = 576  # kMaxK in csrc/nd_tail.cu: one warp a row, candidate groups in a 32-bit mask

_SRC = Path(__file__).resolve().parent / "csrc" / "nd_tail.cu"

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bind(lib: ctypes.CDLL) -> None:
    lib.nd_tail_launch.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nd_tail_launch.restype = ctypes.c_int
    lib.nd_tail_max_k.argtypes = []
    lib.nd_tail_max_k.restype = ctypes.c_int
    lib.nd_tail_smem.argtypes = [ctypes.c_int]
    lib.nd_tail_smem.restype = ctypes.c_int
    if lib.nd_tail_max_k() != MAX_K:
        raise RuntimeError(f"nd_tail.cu takes K <= {lib.nd_tail_max_k()}, MAX_K is {MAX_K}")


KERNEL = CudaKernel(_SRC, _bind)


def _check(valid, b1a, b1b, b0, player, d_hi, d_lo) -> None:
    n = valid.shape[0]
    shapes = (
        ("valid", valid, (n, N_CAND), (torch.bool,)),
        ("b1a", b1a, (n, N_SLOTS, N_CELLS), (torch.int8,)),
        ("b1b", b1b, (n, N_SLOTS, N_CELLS), (torch.int8,)),
        ("b0", b0, (n, N_CELLS), (torch.int8,)),
        ("player", player, (n,), None),
        ("d_hi", d_hi, (n,), None),
        ("d_lo", d_lo, (n,), None),
    )
    for name, t, shape, dtypes in shapes:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if tuple(t.shape) != shape or (dtypes and t.dtype not in dtypes):
            raise ValueError(
                f"{name} must be {dtypes or 'int'} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != valid.device:
            raise ValueError(f"{name} is on {t.device}, valid on {valid.device}")


def nd_tail_plain(
    valid, b1a, b1b, b0, player, d_hi, d_lo, K: int, a_max: int
) -> Outputs:
    """Plain PyTorch version: (after int8 [N, K, 52], keep bool [N, K],
    n_pre int32 [N], pct int32 [N], kpair bool [N, K]) from the candidate
    bits bool [N, 1512], the pass-A and pass-B children int8 [N, 27, 52], the
    root boards int8 [N, 52] and player, d_hi, d_lo [N]. ``after`` is
    meaningful at kept slots. A call on a card (the kernel's oracle, or this
    function put in ``nd_tail_fused``'s place) counts as the tracer's
    ``nd_tail_plain``."""
    _check(valid, b1a, b1b, b0, player, d_hi, d_lo)
    if valid.is_cuda:
        profiling.count("nd_tail_plain")
    as64 = lambda x: x.to(torch.int64)
    after, keep, pct, kpair = _nd_tail(
        Board(b0), Board(b1a), Board(b1b), valid, as64(player), as64(d_hi),
        as64(d_lo), K, a_max,
    )
    return after.data, keep, valid.sum(-1, dtype=torch.int32), pct, kpair


def kernel_operands(valid, b1a, b1b, b0, player, d_hi, d_lo, K: int):
    """Check what the CUDA kernel takes and lay out its operands: contiguous,
    aligned, the candidate bits as uint8 and the per-row scalars as int32.
    Raises on anything the kernel does not take."""
    _check(valid, b1a, b1b, b0, player, d_hi, d_lo)
    if valid.device.type != "cuda":
        raise ValueError(f"the nd_tail kernel runs on cuda, inputs are on {valid.device}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the nd_tail kernel takes 1 <= K <= {MAX_K}, got {K}")
    i32 = lambda x: aligned16(x.to(torch.int32))
    return (
        aligned16(valid).view(torch.uint8), aligned16(b1a), aligned16(b1b),
        aligned16(b0), i32(player), i32(d_hi), i32(d_lo),
    )


def _launch(valid, b1a, b1b, b0, player, d_hi, d_lo, after, keep, n_pre, pct, kpair,
            K: int, a_max: int) -> None:
    """The launch op's CUDA body: the ctypes call on the current stream."""
    lib = KERNEL.load()
    dev = valid.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nd_tail_launch(
            valid.data_ptr(), b1a.data_ptr(), b1b.data_ptr(), b0.data_ptr(),
            player.data_ptr(), d_hi.data_ptr(), d_lo.data_ptr(),
            after.data_ptr(), keep.data_ptr(), n_pre.data_ptr(), pct.data_ptr(),
            kpair.data_ptr(), valid.shape[0], K, a_max, stream,
        )
    if rc != 0:
        raise RuntimeError(f"nd_tail kernel launch failed: CUDA error {rc}")


_LIBRARY = []  # the dispatcher library that holds the launch op, made at the first launch


def _launch_op():
    """The launch as the dispatcher op ``mlp_ppo_torch::nd_tail`` (defined at
    the first launch, for CUDA tensors only). torch.profiler links a kernel
    to the op that launched it, and so to the scopes around that op; a
    ctypes launch made outside any op is linked to no event, and its device
    time falls outside every stage."""
    if not _LIBRARY:
        lib = torch.library.Library("mlp_ppo_torch", "FRAGMENT")
        lib.define("nd_tail(Tensor valid, Tensor b1a, Tensor b1b, Tensor b0, Tensor player, "
                   "Tensor d_hi, Tensor d_lo, Tensor(a!) after, Tensor(b!) keep, "
                   "Tensor(c!) n_pre, Tensor(d!) pct, Tensor(e!) kpair, int k, int a_max) -> ()")
        lib.impl("nd_tail", _launch, "CUDA")
        _LIBRARY.append(lib)
    return torch.ops.mlp_ppo_torch.nd_tail


def launch_kernel(valid, b1a, b1b, b0, player, d_hi, d_lo, K: int, a_max: int) -> Outputs:
    """Launch the CUDA kernel on operands from ``kernel_operands`` on the
    current stream, inside the op ``mlp_ppo_torch::nd_tail``. Counts the
    launch (``CudaKernel.count_launch``: inside a CUDA graph capture it
    counts once per replay)."""
    n = valid.shape[0]
    if not (valid.is_cuda and valid.dtype == torch.uint8 and player.dtype == torch.int32):
        raise ValueError("launch_kernel takes operands from kernel_operands")
    dev = valid.device
    after = torch.empty((n, K, N_CELLS), dtype=torch.int8, device=dev)
    keep = torch.empty((n, K), dtype=torch.bool, device=dev)
    kpair = torch.empty((n, K), dtype=torch.bool, device=dev)
    n_pre = torch.empty((n,), dtype=torch.int32, device=dev)
    pct = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return after, keep, n_pre, pct, kpair
    # asynchronous: the caching allocator reuses the operands' memory only in
    # order on this stream, so temporaries may be freed when this returns
    _launch_op()(valid, b1a, b1b, b0, player, d_hi, d_lo, after, keep, n_pre, pct, kpair,
                 K, a_max)
    KERNEL.count_launch()
    return after, keep, n_pre, pct, kpair


def child_rows(valid: torch.Tensor, K: int) -> torch.Tensor:
    """Per row, the distinct 52-byte child rows of the pass-A and pass-B
    tables (27 each) that the kernel must read: those of the first min(count,
    K) set cells, and pass B's child 26 where the count is under K (the
    clip slot). Cell c lies in block c // 27 (pass-A pairs 0..26, singles
    27, pass-B pairs 28..54, singles 55); a pair takes the child of its
    block, a single the child of its place in the block."""
    c = torch.arange(N_CAND, device=valid.device)
    blk, loc = c // N_SLOTS, c % N_SLOTS
    cpass = (blk >= N_SLOTS + 1).long()
    bb = blk - (N_SLOTS + 1) * cpass
    child = N_SLOTS * cpass + torch.where(bb < N_SLOTS, bb, loc)  # 0..53
    onehot = torch.nn.functional.one_hot(child, 2 * N_SLOTS).float()
    sel = valid & (torch.cumsum(valid.int(), -1) <= K)
    used = (sel.float() @ onehot) > 0
    used[:, 2 * N_SLOTS - 1] |= valid.sum(-1) < K
    return used.sum(-1)


def bound(valid: torch.Tensor, K: int) -> Dict[str, object]:
    """Least time for the kernel on these rows: the bytes it must move
    (1512 candidate bytes, the child rows its selected candidates use,
    ``child_rows``, the 52-byte root and three int32 in; K x 52 afterstates,
    keep and kpair bytes and two int32 out) over HBM bandwidth, and the
    operations this data needs over the CUDA-core rate: every candidate bit
    is read by the select, and each present candidate (at most K) is
    decoded, applied and signed (counted as 64 operations) and compared
    with the earlier ones. Reads the data (sums to the host): not inside a
    timed window or a capture."""
    n = valid.shape[0]
    m = valid.sum(-1).clamp_max(K).to(torch.int64)
    children = int(child_rows(valid, K).sum())
    nbytes = n * (N_CAND + N_CELLS + 3 * 4) + N_CELLS * children + n * (
        K * N_CELLS + 2 * K + 2 * 4)
    ops = n * N_CAND + int((64 * m + m * (m - 1) // 2).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return dict(
        rows=n, K=K, present_per_row=float(m.float().mean()) if n else 0.0,
        child_rows_per_row=children / max(n, 1), bytes=nbytes, ops=ops,
        bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def _count(valid: torch.Tensor, K: int) -> Dict[str, float]:
    """One call's count for ``utils.cost``: its integer operations and bytes."""
    b = bound(valid, K)
    return {"elementwise_ops": b["ops"], "bytes": b["bytes"]}


def nd_tail_fused(
    valid, b1a, b1b, b0, player, d_hi, d_lo, K: int, a_max: int
) -> Outputs:
    """The whole non-doubles tail of ``movegen2._nd_tail`` for a flat batch;
    returns (after, keep, n_pre, pct, kpair) as ``nd_tail_plain`` does.

    A CPU tensor goes to ``nd_tail_plain``; a CUDA tensor to the CUDA kernel
    (which raises if it cannot build or launch); anything else raises."""
    if not isinstance(valid, torch.Tensor):
        raise TypeError("valid must be a torch.Tensor")
    kind = valid.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"nd_tail_fused cannot run on device {valid.device}")
    with cost.kernel("nd_tail_kernel", lambda: _count(valid, K)):
        if kind == "cpu":
            return nd_tail_plain(valid, b1a, b1b, b0, player, d_hi, d_lo, K, a_max)
        ops = kernel_operands(valid, b1a, b1b, b0, player, d_hi, d_lo, K)
        return launch_kernel(*ops, K, a_max)
