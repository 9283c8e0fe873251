"""The one seam of every hand-written kernel: its build, binding and launch.

Each hand-written kernel lives in a ``csrc/*.cu`` file with a plain C
interface. At first use it is compiled for ``sm_90a`` into a shared library
under ``ops/_build/`` (git-ignored), named by a hash of the source and the
flags, so a changed source never loads a stale library, and bound with
ctypes. ``-Xptxas -v`` is on and its report (registers, spills, shared
memory) is kept beside the library. Every kernel launches through
``CudaKernel.launch``, inside a dispatcher op of its own, and counts its
launches there. Nothing here runs at import time: the CPU tests import
every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.utils import profiling

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


_SMS: Dict[int, int] = {}  # device index -> SM count


def sm_count(dev: torch.device) -> int:
    """The SM count of a card, read once a device (the launch planners
    spread small batches over the SMs)."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' 16-byte loads need (a
    fresh copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# the package's dispatcher library, which holds every kernel's launch op; made
# at the first op's definition
_LIBRARY: List[torch.library.Library] = []


class CudaKernel:
    """One CUDA source: its library (built and bound at first ``load``), its
    build record, its launch op, and the count of its launches.

    ``launch(*args)`` runs the kernel inside the dispatcher op
    ``mlp_ppo_torch::<name>``, defined from ``schema`` (outputs written in
    place marked ``Tensor(a!)``) at the first launch, with a CUDA body only:
    torch.profiler links a kernel to the op that launched it, and so to the
    scopes around it, and a ctypes call outside any op to no event. The
    body is ``call(dev, c_args(*args))``, then ``count_launch``.

    ``launches`` counts the launches that ran: each eager launch, and each
    replay of a CUDA graph adds the launches captured in it
    (``utils.profiling.GraphLaunches``); ``captured`` those recorded into
    graphs being captured. The kernel registers itself in
    ``utils.profiling.KERNELS``: the tracer records by update the launches
    of a kernel with a ``counter`` name and the growth of its
    ``device_counters`` (their names, and a function giving the int64
    tensors it adds to, by device); ``per_capture`` (a context manager
    factory) is entered around every capture."""

    def __init__(self, src: Path, bind: Callable[[ctypes.CDLL], None],
                 schema: Optional[str] = None, c_args: Optional[Callable[..., tuple]] = None,
                 *, name: Optional[str] = None, counter: Optional[str] = None,
                 device_counters: Optional[Tuple[Tuple[str, ...], Callable[[], Dict]]] = None,
                 per_capture: Optional[Callable[[], ContextManager]] = None) -> None:
        self.src = src
        self.name = name or src.stem
        self._bind = bind
        self.schema, self._c_args = schema, c_args
        self.counter, self.device_counters, self.per_capture = counter, device_counters, per_capture
        self.lib: Optional[ctypes.CDLL] = None
        self.build_info: Dict[str, object] = {}
        self.launches = 0
        self.captured = 0
        self._op = None
        profiling.KERNELS.append(self)

    def count_launch(self) -> None:
        """Count one launch on the current stream."""
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1

    def load(self) -> ctypes.CDLL:
        """The library, built (or found built) and bound at the first call:
        a ``build`` span, with the build's seconds and whether it was
        cached."""
        if self.lib is None:
            with profiling.scope("build", span=True, kernel=self.src.stem) as attrs:
                so, self.build_info = build(self.src)
                lib = ctypes.CDLL(str(so))
                self._bind(lib)
                self.lib = lib
                attrs.update(cached=self.build_info["cached"],
                             seconds=self.build_info.get("seconds", 0.0))
        return self.lib

    def call(self, dev: torch.device, c_args: tuple) -> None:
        """The library's ``<name>_launch(*c_args, stream)`` on ``dev``'s
        current stream; raises on a non-zero return (a CUDA error). The
        launch is asynchronous: the caching allocator reuses the operands'
        memory only in order on this stream, so the caller's temporaries may
        be freed when it returns."""
        lib = self.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib, f"{self.name}_launch")(*c_args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {rc}")

    def _body(self, *args) -> None:
        """The op's CUDA body."""
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        self.call(dev, self._c_args(*args))
        self.count_launch()

    def op(self):
        """The launch op ``torch.ops.mlp_ppo_torch.<name>``, defined at the
        first call."""
        if self._op is None:
            if not _LIBRARY:
                _LIBRARY.append(torch.library.Library("mlp_ppo_torch", "FRAGMENT"))
            _LIBRARY[0].define(self.name + self.schema)
            _LIBRARY[0].impl(self.name, self._body, "CUDA")
            self._op = getattr(torch.ops.mlp_ppo_torch, self.name)
        return self._op

    def launch(self, *args) -> None:
        """Launch the kernel through its op on op arguments ``args``."""
        self.op()(*args)
