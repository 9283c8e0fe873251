"""One time stamp into a ring of rows: the tracer's clock inside the step.

Contract: ring int64 [slots, width], cursor int64 [1], on one device.
``stamp(ring, cursor, col, close)`` writes the time into
``ring[cursor % slots, col]``. A row's last stamp passes ``close``, the
row's kind (1-7; 0 for the others): it also writes ``cursor * 8 + close``
into the row's last column (the row's sequence number and kind, for the
host to check) and adds one to the cursor.

Two implementations of one function:

* ``stamp_plain`` — the CPU path: the host's ``time.perf_counter_ns()``, the
  clock of the tracer's host spans, written through numpy views;
* the CUDA kernel ``csrc/stamp.cu`` (sm_90a): the device's ``%globaltimer``
  in nanoseconds, read and written by one thread on the current stream, so
  it can sit inside a captured CUDA graph, whose replays advance the cursor;
  launched inside the dispatcher op ``mlp_ppo_torch::stamp``.

``stamp`` routes a CPU ring to the plain version and a CUDA ring to the
kernel, and raises on anything else; it is the tracer's stamp writer
(``utils.profiling.CLOCK``), registered when the kernel package is
imported. Nothing here synchronises the host with the card.
"""
from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling

_SRC = Path(__file__).resolve().parent / "csrc" / "stamp.cu"
KERNEL_NAME = "stamp_kernel"  # the kernel's name in a profiler trace


def _bind(lib: ctypes.CDLL) -> None:
    lib.stamp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.stamp_launch.restype = ctypes.c_int


KERNEL = CudaKernel(
    _SRC, _bind, "(Tensor(a!) ring, Tensor(b!) cursor, int col, int close) -> ()",
    lambda ring, cursor, col, close: (ring.data_ptr(), cursor.data_ptr(), ring.shape[0],
                                      ring.shape[1], col, close))


def _check(ring: torch.Tensor, cursor: torch.Tensor, col: int, close: int) -> None:
    if ring.dtype != torch.int64 or ring.dim() != 2 or not ring.is_contiguous():
        raise ValueError(f"ring must be a contiguous int64 [slots, width], got {ring.dtype} "
                         f"{tuple(ring.shape)}")
    if cursor.dtype != torch.int64 or cursor.shape != (1,) or cursor.device != ring.device:
        raise ValueError("cursor must be an int64 [1] on the ring's device")
    if not 0 <= col < ring.shape[1] - 1:
        raise ValueError(f"column {col} outside the ring's {ring.shape[1] - 1} stamp columns")
    if not 0 <= close <= 7:
        raise ValueError(f"a row's kind is 1-7 (0: not its last stamp), got {close}")


def stamp_plain(ring: torch.Tensor, cursor: torch.Tensor, col: int, close: int) -> None:
    """The CPU version: host nanoseconds (``time.perf_counter_ns``), written
    through numpy views, so no torch op runs (an op counter or a profiler
    sees none)."""
    _check(ring, cursor, col, close)
    t = time.perf_counter_ns()
    rows, cur = ring.numpy(), cursor.numpy()
    c = int(cur[0])
    row = rows[c % rows.shape[0]]
    row[col] = t
    if close:
        row[-1] = c * 8 + close
        cur[0] = c + 1


def launch_kernel(ring: torch.Tensor, cursor: torch.Tensor, col: int, close: int) -> None:
    """Launch the CUDA kernel on the current stream, inside the op
    ``mlp_ppo_torch::stamp``. Counts the launch (``CudaKernel.count_launch``)."""
    _check(ring, cursor, col, close)
    if not ring.is_cuda:
        raise ValueError(f"the stamp kernel runs on cuda, the ring is on {ring.device}")
    KERNEL.launch(ring, cursor, col, close)


def stamp(ring: torch.Tensor, cursor: torch.Tensor, col: int, close: int = 0) -> None:
    """One stamp into ``ring[cursor % slots, col]``, closing the row where
    ``close`` (its kind) is not 0 (see the module's docstring): the plain
    version on the CPU, the kernel on a card."""
    kind = ring.device.type
    if kind == "cpu":
        stamp_plain(ring, cursor, col, close)
    elif kind == "cuda":
        launch_kernel(ring, cursor, col, close)
    else:
        raise ValueError(f"stamp cannot run on device {ring.device}")


profiling.CLOCK.append(stamp)
