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
* the CUDA kernel ``csrc/fused_value.cu`` (sm_90a), built with ``nvcc`` at
  first use into ``_build/`` (keyed by a hash of the source) and bound with
  ``ctypes``.

``fused_value`` routes a CPU tensor to the plain version and a CUDA tensor
to the kernel, and raises on anything else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

N_CELLS = 52  # 48 point cells + bar x2 + off x2 (engine/board.py layout)
N_REP = 4 * N_CELLS  # 208

_SRC = Path(__file__).resolve().parent / "csrc" / "fused_value.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


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


class _Kernel:
    """The built CUDA library, its build record and the launch count."""

    def __init__(self) -> None:
        self.lib: Optional[ctypes.CDLL] = None
        self.build_info: Dict[str, object] = {}
        self.launches = 0

    def load(self) -> ctypes.CDLL:
        if self.lib is None:
            so, self.build_info = _build()
            lib = ctypes.CDLL(str(so))
            lib.fused_value_launch.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_longlong,
                ctypes.c_void_p,
            ]
            lib.fused_value_launch.restype = ctypes.c_int
            lib.fused_value_hidden.argtypes = []
            lib.fused_value_hidden.restype = ctypes.c_int
            self.lib = lib
        return self.lib


KERNEL = _Kernel()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build():
    """Compile csrc/fused_value.cu into _build/ unless a library built from
    the same source and flags is there. Returns (path, build record)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"fused_value_{tag}.so"
    log = so.with_suffix(".ptxas.txt")  # what -Xptxas -v said at build time
    if so.exists():
        ptxas = log.read_text() if log.exists() else ""
        return so, {"path": str(so), "cached": True, "ptxas": ptxas}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    ptxas = (proc.stdout + proc.stderr).strip()
    log.write_text(ptxas)
    os.replace(tmp, so)
    return so, {"path": str(so), "cached": False, "seconds": secs, "ptxas": ptxas}


def kernel_operands(boards_data, flag, params) -> Tuple[torch.Tensor, ...]:
    """Check what the CUDA kernel takes and lay out its operands:
    (boards, flag int8 [...], G, b1', tflip, w2, b2), all on the boards'
    device and contiguous. Raises on anything the kernel does not take."""
    _check_boards(boards_data)
    dev = boards_data.device
    if dev.type != "cuda":
        raise ValueError(f"the fused_value kernel runs on cuda, boards are on {dev}")
    if not boards_data.is_contiguous():
        raise ValueError("fused_value kernel needs contiguous boards")
    lib = KERNEL.load()
    g, b1p, tflip, w2r, b2 = (t.contiguous() for t in recombine_params(params))
    if g.shape[1] != lib.fused_value_hidden():
        raise ValueError(
            f"fused_value kernel is built for hidden={lib.fused_value_hidden()},"
            f" params have {g.shape[1]}"
        )
    for name, t in (("G", g), ("b1'", b1p), ("tflip", tflip), ("w2", w2r), ("b2", b2)):
        if t.device != dev:
            raise ValueError(f"param {name} is on {t.device}, boards on {dev}")
    if g.data_ptr() % 16:
        raise ValueError("G must be 16-byte aligned")
    f = torch.broadcast_to(torch.as_tensor(flag, device=dev), boards_data.shape[:-1])
    return boards_data, f.to(torch.int8).contiguous(), g, b1p, tflip, w2r, b2


def launch_kernel(boards, f, g, b1p, tflip, w2r, b2) -> torch.Tensor:
    """Launch the CUDA kernel on operands from ``kernel_operands`` on the
    current stream; f32 [...] out. Counts the launch."""
    n = boards.numel() // N_CELLS
    if not (boards.is_cuda and boards.dtype == torch.int8 and boards.is_contiguous()):
        raise ValueError("launch_kernel takes operands from kernel_operands")
    if not (f.dtype == torch.int8 and f.numel() == n and f.is_contiguous()
            and f.device == boards.device):
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
            boards.data_ptr(), f.data_ptr(), g.data_ptr(), b1p.data_ptr(),
            tflip.data_ptr(), w2r.data_ptr(), b2.data_ptr(), out.data_ptr(),
            n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_value kernel launch failed: CUDA error {rc}")
    KERNEL.launches += 1
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
