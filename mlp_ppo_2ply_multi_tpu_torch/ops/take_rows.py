"""A per-game row take: ``out[n, k] = boards[n, idx[n, k]]``.

Counterpart of the three TPU kernels of ``scripts/probe_pallas_batched_dot.py``
that compute this function as one-hot products on the TPU's matrix unit:
``take_pallas`` (P1, the one-hot built outside the kernel), ``take_pallas_fused``
(P2, built inside) and ``take_bdiag`` (P3, a block-diagonal product over a
few games). Their tile sizes (R, r) are VMEM blocks and mean nothing here.

Contract: boards int8 [N, W, C], idx int32 or int64 [N, K] -> int8 [N, K, C].
An index outside [0, W) gives a zero row, as the one-hot of P1/P2 with no
match does (P3 would read a neighbouring game; the probe never feeds one).

Two implementations of one function, bit-identical:

* ``take_rows_plain`` — advanced indexing and a mask, the CPU path and on the
  card the kernel's oracle;
* the CUDA kernel ``csrc/take_rows.cu`` (sm_90a), built with ``nvcc`` at
  first use (``ops/_cuda_build.py``) and bound with ``ctypes``.

``take_rows`` routes a CPU tensor to the plain version and a CUDA tensor to
the kernel, and raises on anything else. The sorted move generator
(``engine.movegen``, ``algo="sorted"``) takes its first-ply, parent and
forced-shorter rows through it; the canonical engine's ``board_take`` stays
``torch.gather``. ``plan`` says which branch of the kernel (a game's table
staged in shared memory, or its used rows gathered) a shape takes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel

_SRC = Path(__file__).resolve().parent / "csrc" / "take_rows.cu"
_INT32_MAX = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    lib.take_rows_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.take_rows_launch.restype = ctypes.c_int
    lib.take_rows_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.take_rows_plan.restype = ctypes.c_int


KERNEL = CudaKernel(_SRC, _bind)


def _check(boards, idx) -> None:
    for name, t in (("boards", boards), ("idx", idx)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if boards.dim() != 3 or boards.dtype != torch.int8:
        raise ValueError(f"boards must be int8 [N, W, C], got {boards.dtype} {tuple(boards.shape)}")
    if idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32 or int64 [N, K], got {idx.dtype} {tuple(idx.shape)}")
    if idx.shape[0] != boards.shape[0]:
        raise ValueError(f"idx has {idx.shape[0]} games, boards {boards.shape[0]}")
    if idx.device != boards.device:
        raise ValueError(f"idx is on {idx.device}, boards on {boards.device}")


def take_rows_plain(boards: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int8 [N, K, C], zero rows where idx lies
    outside [0, W)."""
    _check(boards, idx)
    n, w, c = boards.shape
    i = idx.to(torch.int64)
    ok = (i >= 0) & (i < w)
    if w == 0:
        return torch.zeros((n, idx.shape[1], c), dtype=boards.dtype, device=boards.device)
    games = torch.arange(n, device=boards.device)[:, None]
    rows = boards[games, i.clamp(0, w - 1)]
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=boards.dtype,
                                                        device=boards.device))


def plan(n: int, w: int, k: int, c: int) -> dict:
    """The kernel's launch plan for these shapes (builds the library):
    ``staged`` (the table in shared memory) or the row gather, games a CTA,
    rows a gather tile, shared memory bytes."""
    out = (ctypes.c_int * 4)()
    rc = KERNEL.load().take_rows_plan(n, w, k, c // 4, out)
    if rc != 0:
        raise ValueError(f"the take_rows kernel takes no [{n}, {k}, {c}] from W = {w}")
    return dict(staged=bool(out[0]), games=out[1], tile_rows=out[2], smem_bytes=out[3])


def launch_kernel(boards: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. The operands must be
    contiguous and 4-byte aligned, with C a multiple of 4 (up to about
    3 KB); raises otherwise. Counts the launch (``CudaKernel.count_launch``)."""
    _check(boards, idx)
    if not boards.is_cuda:
        raise ValueError(f"the take_rows kernel runs on cuda, inputs are on {boards.device}")
    n, w, c = boards.shape
    k = idx.shape[1]
    if c % 4:
        raise ValueError(f"the take_rows kernel takes rows of a multiple of 4 bytes, C is {c}")
    for name, t in (("boards", boards), ("idx", idx)):
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"the take_rows kernel takes a contiguous, 4-byte aligned {name}")
    cw = c // 4
    if n * k * cw > _INT32_MAX or n * w * cw > _INT32_MAX:
        raise ValueError(f"the take_rows kernel takes fewer than 2^31 words, got "
                         f"[{n}, {k}, {c}] from [{n}, {w}, {c}]")
    out = torch.empty((n, k, c), dtype=torch.int8, device=boards.device)
    if out.numel() == 0:
        return out
    lib = KERNEL.load()
    with torch.cuda.device(boards.device):
        stream = torch.cuda.current_stream(boards.device).cuda_stream
        rc = lib.take_rows_launch(boards.data_ptr(), idx.data_ptr(), idx.element_size(),
                                  out.data_ptr(), n, w, k, cw, stream)
    if rc != 0:
        raise RuntimeError(f"take_rows kernel launch failed: CUDA error {rc}")
    KERNEL.count_launch()
    return out


def take_rows(boards: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[n, k] = boards[n, idx[n, k]]`` (zero rows for indices outside
    [0, W)). A CPU tensor goes to ``take_rows_plain``; a CUDA tensor to the
    CUDA kernel (which raises if it cannot build or launch, or on operands it
    does not take); anything else raises."""
    if not isinstance(boards, torch.Tensor):
        raise TypeError("boards must be a torch.Tensor")
    kind = boards.device.type
    if kind == "cpu":
        return take_rows_plain(boards, idx)
    if kind == "cuda":
        return launch_kernel(boards, idx)
    raise ValueError(f"take_rows cannot run on device {boards.device}")
