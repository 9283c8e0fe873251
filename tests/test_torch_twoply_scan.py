"""The 2-ply scan scorer and the value-first replies against the JAX package.

``weighted_opponent_response`` runs its scan branch when ``unroll_rolls`` is
off, ``roll_chunk`` is above 1 or ``value_first_m`` is set. Checked on the
f32 value path (encode + forward), on [16, 4] candidate boards made from a
seed, against JAX's scorer at ``roll_chunk`` 3, at 4 (the last chunk of
each scan padded with zero-probability repeats) and with
``value_first_m=16``: scores within rtol 1e-5 and atol 1e-6 (the same f32
function, its chunk sums and top-5 means added in another order; a score
sums 21 terms of magnitude below ~1 and of either sign, the value head
being linear, so near 0 a relative bound alone does not hold), the inexact
flags equal.
Each JAX scorer is lowered in its own spawned interpreter, as
tests/test_torch_twoply.py explains. Port only: at ``roll_chunk`` 1 the scan
equals the unrolled scorer bit for bit (f32 and the fused bf16 path), and
the value-first replies dedup the same by signature and by board.
"""
import dataclasses
import multiprocessing
import pathlib

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax as tX
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_twoply import twoply_cfg
from tests.test_torch_twoply_engine import _candidate_batch

CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
RTOL, ATOL = 1e-5, 1e-6
N = 16
# the uniform reply widths the scan reads (it ignores the per-roll ones)
SCAN = dict(dd_reply_widths=(), nd_reply_widths=())
VARIANTS = {
    "chunk3": dict(SCAN, roll_chunk=3),
    "chunk4_padded": dict(SCAN, roll_chunk=4),
    "value_first16": dict(SCAN, value_first_m=16),
}


def _inputs():
    boards, opp = _candidate_batch(21)
    return boards[:N], opp[:N]


def jax_scores(td_mode, twoply):
    """JAX's weighted_opponent_response with its flags, on ``_inputs``, in
    this (spawned) interpreter."""
    import jax
    import jax.numpy as jnp

    from mlp_ppo_2ply_multi_tpu.core import config as jcfg
    from mlp_ppo_2ply_multi_tpu.engine import board as jB
    from mlp_ppo_2ply_multi_tpu.model import value_net as jV
    from mlp_ppo_2ply_multi_tpu.twoply import expectimax as jX

    jax.config.update("jax_platforms", "cpu")
    boards, opp = _inputs()
    cfg = twoply_cfg(jcfg, td_mode, False, **twoply)
    params = jV.load_torch_checkpoint(CKPT)
    f = jax.jit(lambda p, b, o: jX.weighted_opponent_response(p, b, o, cfg, return_flags=True))
    w, flags = f(params, jB.Board(jnp.asarray(boards)), jnp.asarray(opp))
    return np.asarray(w), np.asarray(flags)


@pytest.fixture(scope="module")
def jax_runs():
    """Each variant's JAX scores, one fresh interpreter each, all at once."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(VARIANTS), maxtasksperchild=1) as pool:
        jobs = {k: pool.apply_async(jax_scores, ("side0", tw)) for k, tw in VARIANTS.items()}
        return {k: j.get(timeout=900) for k, j in jobs.items()}


def _port(twoply, fused=False, **movegen):
    cfg = twoply_cfg(tcfg, "side0", fused, **twoply)
    if movegen:
        cfg = cfg.replace(movegen=dataclasses.replace(cfg.movegen, **movegen))
    boards, opp = _inputs()
    params = tV.load_checkpoint(CKPT, device="cpu")
    return tX.weighted_opponent_response(
        params, tB.Board(torch.from_numpy(boards)), torch.from_numpy(opp), cfg,
        return_flags=True)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_scan_scorer_matches_jax(jax_runs, variant):
    want, want_flags = jax_runs[variant]
    got, flags = _port(VARIANTS[variant])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    assert np.isfinite(want).all() and (want != 0).any()


@pytest.mark.parametrize("fused", [False, True], ids=["f32", "fused_bf16"])
def test_scan_at_chunk_1_equals_the_unrolled_scorer(fused):
    """Same per-roll math, same accumulation order: bit-equal scores."""
    unrolled, _ = _port(SCAN, fused)
    scan, flags = _port(dict(SCAN, unroll_rolls=False), fused)
    assert torch.equal(scan, unrolled) and not bool(flags.any())


def test_value_first_dedups_the_same_by_signature_and_by_board():
    sig = _port(VARIANTS["value_first16"])
    gram = _port(VARIANTS["value_first16"], nd_sig_dedup=False)
    assert torch.equal(sig[0], gram[0]) and torch.equal(sig[1], gram[1])


def test_value_first_equals_the_reference_order_scan_where_exact():
    """Where the inexact flag is clear the value-first scores equal the
    reference-order dedup path's (JAX tests/test_twoply_valuefirst.py: the
    same top-5 distinct values, summed in another order)."""
    ref, _ = _port(dict(SCAN, unroll_rolls=False))
    vf, flags = _port(VARIANTS["value_first16"])
    clear = ~flags
    assert bool(clear.any())
    torch.testing.assert_close(vf[clear], ref[clear], rtol=1e-6, atol=1e-7)
