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

The JAX script's other modes are one-hot products that XLA formulated, with
no Pallas kernel behind them; each is the same product here, through
``torch.bmm`` (cuBLAS on the card) on the selector ``parent[..., None] ==
arange(W)``:

* ``xla``: bf16 operands, f32 accumulation (cuBLAS's reduced-precision
  bf16 reduction switched off for the call);
* ``bf16acc``: the same product with that reduced-precision reduction
  allowed, the nearest torch has to JAX's bf16 accumulation (torch has no
  bf16-accumulating product);
* ``int8``, ``int8acc``: int8 operands, int32 accumulation. ``torch.bmm``
  refuses int8 on the card and ``torch._int_mm`` is 2-D only (rows above
  16, inner and outer sizes multiples of 8), so the exact formulation is
  block-diagonal: for each tile of ``INT8_TILE`` games one
  ``torch._int_mm`` of the [tile x K, tile x W] one-hot selector by the
  tile's stacked table [tile x W, C padded to 56]. ``int8acc`` (JAX: int8
  accumulation) casts the same int32 product to int8; torch has no
  int8-accumulating product;
* ``f32``: f32 operands and accumulation (TF32 off for the call);
* ``packed``: four cells a f32 lane as base-32 digits (52 cells in 13
  lanes), the f32 product, then the digits decoded (TF32 off: the lanes
  need 20 bits of mantissa);
* ``ohonly``: the bf16 selector alone, summed over W to keep it live; it
  takes nothing, so its check prints ``n/a``;
* ``dotonly``: the bf16 product on a selector built before the timing;
* ``bf16T``: the selector built transposed, [N, W, K], and contracted over
  W (``torch.bmm`` of its transpose).

R (the JAX script's games per grid step) is accepted and printed; it is a
TPU tile and means nothing here. Exits 1 when the result is not exact.

Usage:
    python -m mlp_ppo_2ply_multi_tpu_torch.scripts.probe_take [mode] [N] [R] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.ops.take_rows import take_rows, take_rows_plain

K, W, C = 128, 128, 52
ITERS = 20
INT8_TILE = 32  # games per block-diagonal torch._int_mm of the int8 modes


def torch_gather(boards: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    idx = parent.to(torch.int64)[..., None].expand(*parent.shape, boards.shape[-1])
    return torch.gather(boards, 1, idx)


@contextlib.contextmanager
def _matmul(tf32: bool = False, bf16_reduced: bool = False):
    """cuBLAS's TF32 and reduced-precision bf16 reduction switches for the
    duration of one product (both only matter on the card)."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32, m.allow_bf16_reduced_precision_reduction = tf32, bf16_reduced
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def one_hot(parent: torch.Tensor, dtype: torch.dtype, w: int = W) -> torch.Tensor:
    """The selector [N, K, W]: parent[n, k] == w."""
    lanes = torch.arange(w, device=parent.device, dtype=parent.dtype)
    return (parent[..., None] == lanes).to(dtype)


def take_xla(boards, parent, bf16_reduced: bool = False):
    with _matmul(bf16_reduced=bf16_reduced):
        out = torch.bmm(one_hot(parent, torch.bfloat16, boards.shape[1]),
                        boards.to(torch.bfloat16))
    return out.to(torch.int8)


def take_xla_bf16acc(boards, parent):
    return take_xla(boards, parent, bf16_reduced=True)


def take_int8(boards, parent):
    """Block-diagonal int8 x int8 -> int32 products, ``INT8_TILE`` games a
    ``torch._int_mm``."""
    n, w, c = boards.shape
    k = parent.shape[1]
    cp = -(-c // 8) * 8
    tab = torch.nn.functional.pad(boards, (0, cp - c))  # [n, w, cp]
    out = torch.empty((n, k, c), dtype=torch.int8, device=boards.device)
    for t in range(0, n, INT8_TILE):
        g = min(INT8_TILE, n - t)
        offs = w * torch.arange(g, device=parent.device, dtype=parent.dtype)
        sel = one_hot((parent[t:t + g] + offs[:, None]).reshape(g * k), torch.int8, g * w)
        b_cm = tab[t:t + g].reshape(g * w, cp).t().contiguous().t()  # column-major
        prod = torch._int_mm(sel, b_cm)  # int32 [g * k, cp]
        out[t:t + g] = prod[:, :c].reshape(g, k, c).to(torch.int8)
    return out


def take_f32(boards, parent):
    with _matmul(tf32=False):
        out = torch.bmm(one_hot(parent, torch.float32, boards.shape[1]), boards.float())
    return out.to(torch.int8)


def take_packed(boards, parent):
    """Four cells (values in [-16, 16)) a f32 lane as base-32 digits: 20
    bits, exact in f32's 24-bit mantissa."""
    n, w, c = boards.shape
    cp = -(-c // 4)
    b = torch.nn.functional.pad(boards.float() + 16.0, (0, cp * 4 - c), value=16.0)
    scale = torch.tensor([1.0, 32.0, 32.0 ** 2, 32.0 ** 3], device=boards.device)
    packed = (b.reshape(n, w, cp, 4) * scale).sum(-1)  # [n, w, cp]
    with _matmul(tf32=False):
        out = torch.bmm(one_hot(parent, torch.float32, w), packed)  # [n, K, cp]
    digits = torch.stack([torch.floor_divide(out, 32.0 ** i) % 32.0 for i in range(4)], -1)
    return (digits.reshape(n, parent.shape[1], cp * 4)[..., :c] - 16.0).to(torch.int8)


def oh_only(boards, parent):
    return one_hot(parent, torch.bfloat16, boards.shape[1]).sum(-1)


def dot_only(boards, oh):
    with _matmul(bf16_reduced=True):
        return torch.bmm(oh, boards.to(torch.bfloat16)).to(torch.int8)


def take_bf16T(boards, parent):
    w = boards.shape[1]
    lanes = torch.arange(w, device=parent.device, dtype=parent.dtype)
    oh_t = (parent[:, None, :] == lanes[None, :, None]).to(torch.bfloat16)  # [N, W, K]
    with _matmul(bf16_reduced=True):
        return torch.bmm(oh_t.transpose(1, 2), boards.to(torch.bfloat16)).to(torch.int8)


MODES = {
    **{m: take_rows for m in ("batched", "loop", "fused", "bdiag4", "bdiag8", "bdiag16")},
    "gather": torch_gather,
    "plain": take_rows_plain,
    "xla": take_xla, "bf16acc": take_xla_bf16acc, "int8": take_int8,
    "int8acc": take_int8, "f32": take_f32, "packed": take_packed,
    "ohonly": oh_only, "dotonly": dot_only, "bf16T": take_bf16T,
}
# the JAX script's modes with no Pallas kernel behind them
XLA_MODES = ("xla", "bf16acc", "int8", "int8acc", "f32", "packed", "ohonly", "dotonly",
             "bf16T")


def mode_fn(mode: str, boards: torch.Tensor, parent: torch.Tensor):
    """The call ``f(boards, parent)`` a mode times: ``dotonly`` gets its
    bf16 selector built here, outside the timing."""
    f = MODES[mode]
    if mode == "dotonly":
        oh = one_hot(parent, torch.bfloat16, boards.shape[1])
        return lambda b, p: dot_only(b, oh)
    return f


def check(mode: str, out: torch.Tensor, boards: torch.Tensor, parent: torch.Tensor):
    """True when ``out`` equals numpy's take; "n/a" for ``ohonly``."""
    if mode == "ohonly":
        return "n/a"
    ref = np.take_along_axis(boards.cpu().numpy(), parent.cpu().numpy()[..., None], axis=1)
    return bool(np.array_equal(out.cpu().numpy(), ref))


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
    f = mode_fn(args.mode, boards, parent)
    ok = check(args.mode, f(boards, parent), boards, parent)
    print("exact:", ok)
    ms = time_ms(f, boards, parent, dev)
    print(f"{args.mode}: {ms:.3f} ms for [{args.n},{K},{W}]x[{args.n},{W},{C}] "
          f"(R={args.r} unused; {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    return 0 if ok in (True, "n/a") else 1


if __name__ == "__main__":
    sys.exit(main())
