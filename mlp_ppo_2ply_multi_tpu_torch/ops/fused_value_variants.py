"""Time variants of the fused_value CUDA kernel against the kept one.

Each variant is ``csrc/fused_value.cu`` with one edit of its text, written
under ``ops/_build/variants/`` and built like the kernel itself. All are
launched on the same operands (one 2-ply reply batch of 393,216 in-domain
boards, the in-repo checkpoint's weights) and timed with CUDA events in the
order kept, variants, variants reversed, kept. Each variant's max |dv|
against ``fused_value_plain`` is reported beside its time, and its ptxas
report (registers, spills). On a machine with one CUDA card:

    python -m mlp_ppo_2ply_multi_tpu_torch.ops.fused_value_variants

Variants:

* ``fast_sigmoid``: the epilogue's sigmoid as ``__expf`` and a bare
  ``rcp.approx``, without the Newton step that makes the reciprocal
  correctly rounded;
* ``warpgroups_2``, ``warpgroups_4``: two or four warpgroups a CTA in place
  of three.
"""
from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import BUILD_DIR, CudaKernel

ROWS = 393_216  # one 2-ply reply batch: 1024 games x 4 candidates x 96 replies
CKPT = Path(__file__).resolve().parents[2] / "checkpoints" / "side0_20480000.pth"

# name -> [(text in csrc/fused_value.cu, its replacement)]
EDITS = {
    "fast_sigmoid": [
        ("1.0f + expf(fminf(-x, 88.0f))", "1.0f + __expf(fminf(-x, 88.0f))"),
        ("  r = fmaf(r, fmaf(-d, r, 1.0f), r);\n", ""),
    ],
    "warpgroups_2": [("constexpr int kWarpgroups = 3;", "constexpr int kWarpgroups = 2;")],
    "warpgroups_4": [("constexpr int kWarpgroups = 3;", "constexpr int kWarpgroups = 4;")],
}


def variant_source(name: str) -> Path:
    """The kernel's source with variant ``name``'s edits, written to the
    build directory. Raises if an edit no longer finds its text."""
    text = fv._SRC.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in fused_value.cu once")
        text = text.replace(old, new)
    path = BUILD_DIR / "variants" / f"fused_value_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def boards(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """n in-domain boards: 15 checkers a side on random points."""
    data = torch.zeros((n, 52), dtype=torch.int64, device=dev)
    for side in (0, 1):
        pts = 24 * side + torch.randint(0, 24, (n, 15), generator=gen, device=dev)
        data.scatter_add_(1, pts, torch.ones_like(pts))
    return data.to(torch.int8)


def ptxas_summary(info) -> list:
    return [line.strip() for line in str(info.get("ptxas", "")).splitlines()
            if "registers" in line or "spill" in line]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    params = value_net.load_checkpoint(str(CKPT), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = boards(ROWS, gen, dev)
    flag = torch.randint(0, 2, (ROWS,), generator=gen, device=dev)
    ops = fv.kernel_operands(b, flag, params)
    want = fv.fused_value_plain(b, flag, params)

    kernels = {"kept": CudaKernel(fv._SRC, fv._bind)}
    kernels.update({name: CudaKernel(variant_source(name), fv._bind) for name in EDITS})
    out = torch.empty(ROWS, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        rc = lib.fused_value_launch(*(t.data_ptr() for t in ops), out.data_ptr(), ROWS, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    err = {}
    for name, k in kernels.items():
        lib = k.load()
        launch(lib)
        torch.cuda.synchronize(dev)
        err[name] = float((out - want).abs().max())

    def time_ms(lib, iters=30):
        for _ in range(3):
            launch(lib)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            launch(lib)
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1) / iters

    names = list(kernels)
    order = names + names[::-1]
    times = {name: [] for name in names}
    for name in order:
        times[name].append(time_ms(kernels[name].lib))
    for name in names:
        print(json.dumps(dict(
            variant=name, rows=ROWS, ms=times[name], max_abs_err=err[name],
            ptxas=ptxas_summary(kernels[name].build_info), card=card,
        )), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
