"""Probe of the per-game row take ``out[n, k] = boards[n, parent[n, k]]``:
is it exact, and how long does it take?

Counterpart of ``scripts/probe_pallas_batched_dot.py``: the same inputs
(int8 boards [N, W = 128, C = 52] with values 0..4, int32 ``parent``
[N, K = 128] in [0, W), drawn from a seeded generator), the same check
against numpy's ``take_along_axis`` and the same two output lines. The JAX
script's Pallas modes are TPU formulations of this take as one-hot
products; each runs the port's ``ops.take_rows`` kernel here:

* ``batched``, ``loop`` (P1 ``take_pallas``), ``fused`` (P2
  ``take_pallas_fused``), ``bdiag4``, ``bdiag8``, ``bdiag16`` (P3
  ``take_bdiag``): ``take_rows`` (a CUDA kernel on the card);
* ``gather``: ``torch.gather``, the counterpart of the JAX ``take_gather``;
* ``plain``: ``take_rows_plain``.

R (the JAX script's games per grid step) is accepted and printed; it is a
TPU tile and means nothing here. Exits 1 when the result is not exact.

Usage:
    python -m mlp_ppo_2ply_multi_tpu_torch.scripts.probe_take [mode] [N] [R] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.ops.take_rows import take_rows, take_rows_plain

K, W, C = 128, 128, 52
ITERS = 20


def torch_gather(boards: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    idx = parent.to(torch.int64)[..., None].expand(*parent.shape, boards.shape[-1])
    return torch.gather(boards, 1, idx)


MODES = {
    **{m: take_rows for m in ("batched", "loop", "fused", "bdiag4", "bdiag8", "bdiag16")},
    "gather": torch_gather,
    "plain": take_rows_plain,
}


def inputs(n: int, dev: torch.device, seed: int = 0):
    """(boards int8 [n, W, C] in 0..4, parent int32 [n, K] in [0, W))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    boards = torch.randint(0, 5, (n, W, C), generator=gen, device=dev, dtype=torch.int8)
    parent = torch.randint(0, W, (n, K), generator=gen, device=dev, dtype=torch.int32)
    return boards, parent


def time_ms(f, boards, parent, dev: torch.device) -> float:
    """Mean ms a call over ITERS calls after the checked one: CUDA events on
    the card, the host clock on the CPU."""
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(ITERS):
            f(boards, parent)
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        f(boards, parent)
    return (time.perf_counter() - t0) / ITERS * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", nargs="?", default="batched", choices=sorted(MODES))
    ap.add_argument("n", nargs="?", type=int, default=4096)
    ap.add_argument("r", nargs="?", type=int, default=128,
                    help="games per TPU grid step in the JAX script; unused here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    boards, parent = inputs(args.n, dev)
    f = MODES[args.mode]
    out = f(boards, parent)
    ref = np.take_along_axis(boards.cpu().numpy(), parent.cpu().numpy()[..., None], axis=1)
    ok = bool(np.array_equal(out.cpu().numpy(), ref))
    print("exact:", ok)
    ms = time_ms(f, boards, parent, dev)
    print(f"{args.mode}: {ms:.3f} ms for [{args.n},{K},{W}]x[{args.n},{W},{C}] "
          f"(R={args.r} unused; {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
