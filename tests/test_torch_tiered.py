"""The tiered pipeline (``experimental/tiered.py``) and ``dd_tier`` against
the JAX package.

* ``doubles_two_tier`` on a compacted doubles sub-batch, at JAX's own
  forcing settings (tests/test_movegen2.py): narrow widths (8, 8, 8) with
  ``dd_wide_div`` 1, where every wide game re-runs, and (2, 2, 2) with a
  sub-sub-batch of 8, where most wide games keep their narrow result and
  stay flagged (the overflow fallback);
* ``legal_moves`` reads ``dd_tier`` only on its doubles sub-batch branch
  (n > 64), as JAX does; at n <= 64 it changes nothing (the port used to
  refuse any ``dd_tier``);
* ``legal_moves_tiered`` at JAX's tier case (nd_tier 8, dd_tier (4, 4, 8),
  ``tiered_wide_div`` 1) and with a wide plane too small for the flagged
  games;
* the tiered ``rollout_step`` teacher-forced: each step starts from the JAX
  state with the noise JAX's step draws injected (``gumbel_t1`` [B, T],
  ``gumbel_t2`` [wb, W]). Chosen boards must agree on >= 99.9% of rows (0
  disagreements expected), every integer leaf is bit-equal on agreeing
  rows and the observation value is within the bf16 tolerance.

Widths are the reduced ones of tests/test_split_planes.py. Integer and bool
results are bit-equal; boards are compared where their mask is set.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.actor import rollout as jR
from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.engine import movegen2 as jMG2
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.experimental import tiered as jXT
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as tR
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.experimental import tiered as tXT
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from tests.test_torch_gram_dedup import SMALL, assert_moveset_equal, both, cases
from tests.test_torch_rollout import _assert_leaves_equal, _leaves, _midgame_state
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
BF16_TOL = 5e-3
B = 64
TIERED = dict(SMALL, tiered=True, dd_tier=(8, 8, 16), tiered_wide_div=4)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _doubles_batch(seed, n):
    boards, players, _ = cases(seed, n)
    rng = np.random.default_rng(seed)
    dice = np.repeat(rng.integers(1, 7, (n, 1)), 2, 1).astype(np.int32)
    return boards, players, dice


@pytest.mark.parametrize("dd_tier,div", [((8, 8, 8), 1), ((2, 2, 2), 256)],
                         ids=["both_tiers", "overflow_fallback"])
def test_doubles_two_tier_matches_jax(dd_tier, div):
    boards, players, dice = _doubles_batch(11, 48)
    ok = np.arange(48) < 44  # the last rows hold no game
    (jb, jp, jd), (tb, tp, td) = both(boards, players, dice)
    kw = dict(dd_tier=dd_tier, dd_wide_div=div)
    jc, tc = jcfg.MoveGenConfig(**SMALL, **kw), tcfg.MoveGenConfig(**SMALL, **kw)
    want = jax.device_get(jax.jit(lambda b, p, d, o: jXT.doubles_two_tier(b, p, d, o, jc))(
        jb, jp, jd[:, 0], jnp.asarray(ok)))
    got = tXT.doubles_two_tier(tb, tp.long(), td[:, 0].long(), torch.from_numpy(ok), tc)
    assert_moveset_equal(want, got)
    flagged = np.asarray(want.overflow)[ok]
    if div == 1:  # every wide game re-ran: the full chain's result and flags
        full = tMG2.enumerate_doubles(tb, tp.long(), td[:, 0].long(), tc)
        np.testing.assert_array_equal(flagged, full.overflow.numpy()[ok])
        np.testing.assert_array_equal(got.count.numpy()[ok], full.count.numpy()[ok])
    else:
        assert flagged.sum() > 8  # more wide games than the sub-sub-batch holds


@pytest.mark.parametrize("n,dd_tier,div", [(80, (8, 8, 8), 1), (80, (2, 2, 2), 256),
                                           (48, (2, 2, 2), 256)],
                         ids=["sub_batch", "sub_batch_overflow", "whole_batch"])
def test_legal_moves_dd_tier_matches_jax(n, dd_tier, div):
    """JAX reads dd_tier only where n > 64 and dd_subbatch_div > 0; on the
    whole-batch branch the moves equal those without dd_tier."""
    (jb, jp, jd), (tb, tp, td) = both(*cases(12, n, doubles=True))
    kw = dict(dd_tier=dd_tier, dd_wide_div=div)
    jc, tc = jcfg.MoveGenConfig(**SMALL, **kw), tcfg.MoveGenConfig(**SMALL, **kw)
    want = jax.device_get(jax.jit(lambda b, p, d: jMG2.legal_moves(b, p, d, jc))(jb, jp, jd))
    got = tMG2.legal_moves(tb, tp, td, tc)
    assert_moveset_equal(want, got)
    plain = tMG2.legal_moves(tb, tp, td, tcfg.MoveGenConfig(**SMALL))
    same = all(torch.equal(getattr(got, f), getattr(plain, f))
               for f in ("valid", "count", "overflow"))
    assert same == (n <= 64 or div == 1)


def _tiered_equal(want, got):
    m = np.asarray(want.narrow_valid)
    np.testing.assert_array_equal(m, got.narrow_valid.numpy())
    np.testing.assert_array_equal(np.asarray(want.narrow_boards.data)[m],
                                  got.narrow_boards.data.numpy()[m])
    assert_moveset_equal(want.wide, got.wide, "wide.")
    for f in ("wide_player", "in_wide", "wide_slot", "count", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), _np(getattr(got, f)),
                                      err_msg=f)


@pytest.mark.parametrize("wide_div", [1, 32], ids=["all_wide_fit", "wide_overflow"])
def test_legal_moves_tiered_matches_jax(wide_div):
    """Every Tiered field bit-equal at JAX's tier case (nd_tier 8, dd_tier
    (4, 4, 8)); with wide_div 1 no flagged game is dropped, so each game
    presents the full enumeration's boards in order and its overflow flag
    (at these widths the full enumeration overflows too)."""
    (jb, jp, jd), (tb, tp, td) = both(*cases(13, B, doubles=True))
    kw = dict(SMALL, nd_tier=8, dd_tier=(4, 4, 8), tiered=True, tiered_wide_div=wide_div,
              dd_subbatch_div=4)
    jc, tc = jcfg.MoveGenConfig(**kw), tcfg.MoveGenConfig(**kw)
    want = jax.device_get(jax.jit(lambda b, p, d: jXT.legal_moves_tiered(b, p, d, jc))(
        jb, jp, jd))
    got = tXT.legal_moves_tiered(tb, tp, td, tc)
    _tiered_equal(want, got)
    ov = np.asarray(want.overflow)
    if wide_div == 1:
        assert np.asarray(want.in_wide).any()
        full = tMG2.legal_moves(tb, tp, td, dataclasses.replace(tc, dd_subbatch_div=0, nd_tier=0))
        np.testing.assert_array_equal(ov, full.overflow.numpy())
        np.testing.assert_array_equal(got.count.numpy(), full.count.numpy())
        for g in range(B):
            if bool(got.in_wide[g]):
                r = int(got.wide_slot[g])
                rows = got.wide.boards.data[r][got.wide.valid[r]]
            else:
                rows = got.narrow_boards.data[g][got.narrow_valid[g]]
            assert torch.equal(rows, full.boards.data[g][full.valid[g]]), g
    else:
        assert (np.asarray(want.in_wide) != (ov | np.asarray(want.in_wide))).any()


def _tiered_cfg(mod, td_mode):
    return mod.Config(
        movegen=mod.MoveGenConfig(**TIERED),
        model=mod.ModelConfig(fused_actor_kernel=True, actor_tier_width=16,
                              actor_tier_wide_div=4, dtype="bfloat16"),
        train=mod.TrainConfig(td_mode=td_mode),
    )


def test_noise_shapes_of_the_tiered_step():
    cfg = _tiered_cfg(tcfg, "side0")
    W = max(cfg.movegen.a_max, cfg.movegen.nd_dedup_k)
    assert tR._noise_shapes(B, cfg) == (16, 16, W)
    assert tR._noise_shapes(256, cfg) == (16, 64, W)
    nz = tR.draw_noise(B, cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert tuple(nz.gumbel_t1.shape) == (B, 16) and tuple(nz.gumbel_t2.shape) == (16, W)


def _jax_step_fn(jparams, cfg, temp):
    """JAX's ``rollout_step``, jitted, that also returns the noise it draws
    (in its own key order), its Tiered set and its chosen boards (captured
    while the step is traced)."""
    T, W = cfg.movegen.nd_tier, max(cfg.movegen.a_max, cfg.movegen.nd_dedup_k)
    wb = max(8, B // cfg.movegen.tiered_wide_div)

    @jax.jit
    def step(st, key):
        seen = {}
        lm0, ch0 = jXT.legal_moves_tiered, jXT.chosen_tiered

        def lm(*a):
            seen["ti"] = lm0(*a)
            return seen["ti"]

        def ch(*a):
            out = ch0(*a)
            seen["chosen"] = out[0].data
            return out

        jXT.legal_moves_tiered, jXT.chosen_tiered = lm, ch
        try:
            new, t = jR.rollout_step(jparams, st, key, temp, cfg, True)
        finally:
            jXT.legal_moves_tiered, jXT.chosen_tiered = lm0, ch0
        k_act, k_roll, k_reset = jax.random.split(key, 3)
        k1, k2 = jax.random.split(k_act)
        k_start, k_first = jax.random.split(k_reset)
        noise = (
            jax.random.gumbel(k1, (B, T)),
            jax.random.gumbel(k2, (wb, W)),
            jE.roll_dice(k_roll, (B,)),
            jE.roll_nondouble(k_start, (B,)),
            jE.roll_nondouble(k_first, (B,)),
        )
        return new, t, noise, seen["chosen"], seen["ti"]

    return step


@pytest.mark.parametrize("td_mode", ["reference", "side0"])
def test_tiered_rollout_step_teacher_forced(td_mode):
    jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jc, tc = _tiered_cfg(jcfg, td_mode), _tiered_cfg(tcfg, td_mode)
    temp = 0.7
    jstep = _jax_step_fn(jparams, jc, jnp.float32(temp))
    js = jax.tree.map(lambda a: a[:B], _midgame_state(5))
    key = jax.random.PRNGKey(23)
    n_rows = n_agree = n_wide = 0
    for _ in range(6):
        key, sub = jax.random.split(key)
        jnew, jt, (g1, g2, nd, op, fi), jchosen, jti = jax.device_get(jstep(js, sub))
        noise = tR.StepNoise(*(torch.from_numpy(np.array(x)) for x in (g1, g2, nd, op, fi)))
        ts = tE.EnvState(board=tB.Board(torch.from_numpy(np.array(js.board.data))),
                         **{k: torch.from_numpy(np.array(getattr(js, k)))
                            for k in jE.EnvState._fields if k != "board"})
        ti = tXT.legal_moves_tiered(ts.board, ts.player, ts.dice, tc.movegen)
        _tiered_equal(jti, ti)
        tchosen, _ = tXT.chosen_tiered(tparams, ts, ti, noise.gumbel_t1, noise.gumbel_t2,
                                       torch.tensor(temp), tc)
        live = np.asarray(jti.count) > 0
        agree = (np.asarray(jchosen) == tchosen.data.numpy()).all(-1) | ~live
        n_rows += B
        n_agree += int(agree.sum())
        n_wide += int(np.asarray(jti.in_wide).sum())

        tnew, tt = tR.rollout_step(tparams, ts, temp, tc, True, noise=noise, device="cpu")
        lw, lg = _leaves(jt), _leaves(tt)
        for k in lw:
            if k == "value":
                assert np.max(np.abs(lw[k] - lg[k])) <= BF16_TOL
            else:
                np.testing.assert_array_equal(lw[k][agree], lg[k][agree], err_msg=k)
        _assert_leaves_equal(jnew, tnew, rows=agree)
        js = jnew  # teacher forcing
    print(f"td_mode={td_mode}: {n_rows - n_agree} disagreements in {n_rows}, "
          f"{n_wide} wide-plane rows")
    assert n_agree >= 0.999 * n_rows and n_wide > 0


def test_tiered_rollout_chunked_equals_the_loop_on_cpu():
    """Port only: the chunked tiered rollout (eager chunks on the CPU) gives
    the loop's trajectory from one generator seed, and conserves checkers."""
    cfg = _tiered_cfg(tcfg, "side0")
    params = tV.init_params(cfg.model, torch.Generator().manual_seed(4), "cpu")
    runs = []
    for chunked in (False, True):
        gen = torch.Generator().manual_seed(6)
        st = tE.reset(B, gen, device="cpu")
        if chunked:
            runs.append(tR.rollout_chunked(params, st, 1.0, cfg, 8, chunk=4, gen=gen,
                                           device="cpu"))
        else:
            runs.append(tR.rollout_loop(params, st, 1.0, cfg, 8, True, gen=gen, device="cpu"))
    (s1, t1), (s2, t2) = runs
    _assert_leaves_equal(t1, t2)
    _assert_leaves_equal(s1, s2)
    assert bool(tB.checker_conservation_ok(s1.board).all())
    assert bool(t1.recorded.any())
