"""The fused non-doubles tail: select, child take, second-submove apply,
delta signature, first-occurrence dedup, max-submove filter and Q7 cap in
one kernel.

Port of ``mlp_ppo_2ply_multi_tpu/experimental/nd_tail.py`` (the Pallas
kernel built by ``_make_kernel``). It runs wherever the non-doubles tail is
a single full-width pass: the 2-ply scorer's reply enumeration (15 calls a
2-ply step). There JAX chose it with ``MoveGenConfig.nd_tail_kernel``, off
by default because on the TPU the kernel lost to XLA (16-row tiles forced by
scoped VMEM); that says nothing about this card, and the port takes the
kernel whatever the flag says.

Two implementations of one function, bit-identical:

* ``nd_tail_plain`` — plain PyTorch (``movegen2._nd_tail``), the CPU path
  and on the card the kernel's oracle;
* the CUDA kernel ``csrc/nd_tail.cu`` (sm_90a), built with ``nvcc`` at first
  use (``ops/_cuda_build.py``) and bound with ``ctypes``.

``nd_tail_fused`` routes a CPU tensor to the plain version and a CUDA tensor
to the kernel, and raises on anything else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen2 import _nd_tail
from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel, aligned16

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
    meaningful at kept slots."""
    _check(valid, b1a, b1b, b0, player, d_hi, d_lo)
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


def launch_kernel(valid, b1a, b1b, b0, player, d_hi, d_lo, K: int, a_max: int) -> Outputs:
    """Launch the CUDA kernel on operands from ``kernel_operands`` on the
    current stream. Counts the launch (``CudaKernel.count_launch``: inside
    a CUDA graph capture it counts once per replay)."""
    n = valid.shape[0]
    if not (valid.is_cuda and valid.dtype == torch.uint8 and player.dtype == torch.int32):
        raise ValueError("launch_kernel takes operands from kernel_operands")
    lib = KERNEL.load()
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nd_tail_launch(
            valid.data_ptr(), b1a.data_ptr(), b1b.data_ptr(), b0.data_ptr(),
            player.data_ptr(), d_hi.data_ptr(), d_lo.data_ptr(),
            after.data_ptr(), keep.data_ptr(), n_pre.data_ptr(), pct.data_ptr(),
            kpair.data_ptr(), n, K, a_max, stream,
        )
    if rc != 0:
        raise RuntimeError(f"nd_tail kernel launch failed: CUDA error {rc}")
    KERNEL.count_launch()
    return after, keep, n_pre, pct, kpair


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
    if kind == "cpu":
        return nd_tail_plain(valid, b1a, b1b, b0, player, d_hi, d_lo, K, a_max)
    if kind == "cuda":
        ops = kernel_operands(valid, b1a, b1b, b0, player, d_hi, d_lo, K)
        return launch_kernel(*ops, K, a_max)
    raise ValueError(f"nd_tail_fused cannot run on device {valid.device}")
