"""Build a CUDA source of the port with plain ``nvcc`` and bind it with ctypes.

Each hand-written kernel lives in a ``csrc/*.cu`` file with a plain C
interface. At first use it is compiled for ``sm_90a`` into a shared library
under ``ops/_build/`` (git-ignored), named by a hash of the source and the
flags, so a changed source never loads a stale library. ``-Xptxas -v`` is on
and its report (registers, spills, shared memory) is kept beside the library.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.utils.profiling import scope

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc() -> str:
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


def build(src: Path) -> Tuple[Path, Dict[str, object]]:
    """Compile ``src`` into BUILD_DIR unless a library built from the same
    source and flags is there. Returns (path, build record)."""
    text = src.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{src.stem}_{tag}.so"
    log = so.with_suffix(".ptxas.txt")  # what -Xptxas -v said at build time
    if so.exists():
        ptxas = log.read_text() if log.exists() else ""
        return so, {"path": str(so), "cached": True, "ptxas": ptxas}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    ptxas = (proc.stdout + proc.stderr).strip()
    log.write_text(ptxas)
    os.replace(tmp, so)
    return so, {"path": str(so), "cached": False, "seconds": secs, "ptxas": ptxas}


_KERNELS: List["CudaKernel"] = []  # every CudaKernel made, for GraphLaunches


class GraphLaunches:
    """The kernel launches one CUDA graph holds, counted by the wrappers
    while it is captured::

        with GraphLaunches() as held:
            ...  # capture
        graph.replay()
        held.replayed()  # each kernel's count += its launches in the graph
    """

    def __init__(self) -> None:
        self.per_replay: Dict["CudaKernel", int] = {}

    def __enter__(self) -> "GraphLaunches":
        self._before = {k: k.captured for k in _KERNELS}
        return self

    def __exit__(self, *exc) -> None:
        self.per_replay = {
            k: k.captured - self._before.get(k, 0)
            for k in _KERNELS if k.captured != self._before.get(k, 0)
        }

    def replayed(self, times: int = 1) -> None:
        for k, n in self.per_replay.items():
            k.launches += n * times


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' 16-byte loads need (a
    fresh copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class CudaKernel:
    """One CUDA source: its library (built and bound at first ``load``), its
    build record, and the count of launches its wrapper made.

    ``launches`` counts the launches that ran: each eager launch, and each
    replay of a CUDA graph adds the launches captured in it
    (``GraphLaunches``). ``captured`` counts the launches recorded into
    graphs while they were captured, which run only when replayed."""

    def __init__(self, src: Path, bind: Callable[[ctypes.CDLL], None]) -> None:
        self.src = src
        self._bind = bind
        self.lib: Optional[ctypes.CDLL] = None
        self.build_info: Dict[str, object] = {}
        self.launches = 0
        self.captured = 0
        _KERNELS.append(self)

    def count_launch(self) -> None:
        """Count one launch of the wrapper on the current stream."""
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1

    def load(self) -> ctypes.CDLL:
        """The library, built (or found built) and bound at the first call:
        a ``build`` span, with the build's seconds and whether it was
        cached."""
        if self.lib is None:
            with scope("build", span=True, kernel=self.src.stem) as attrs:
                so, self.build_info = build(self.src)
                lib = ctypes.CDLL(str(so))
                self._bind(lib)
                self.lib = lib
                attrs.update(cached=self.build_info["cached"],
                             seconds=self.build_info.get("seconds", 0.0))
        return self.lib
