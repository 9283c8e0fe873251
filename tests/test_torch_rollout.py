"""The port's environment and 1-ply actor step against the JAX package.

* Environment: ``step_chosen``, ``step``, ``reset_where`` and
  ``reset_from_rolls`` are bit-exact over multi-step sequences with injected
  dice and injected choices, from random mid-game and bear-off positions
  (wins of every type, shaping bonuses, passes, truncation).
* Rollout, teacher-forced: each step starts from the JAX state, the noise
  that ``jax.random.categorical``/``roll_dice``/``reset`` draw inside the JAX
  step is derived from the same key and injected into the port's step.
  Decisions must agree on >= 99.9% of rows (0 disagreements expected: the
  values differ only in f32 summation order), every integer leaf of the
  Transition and the next EnvState is bit-equal on agreeing rows, and the
  observation value is within the bf16 tolerance of test_torch_value.py.
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
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.engine import movegen2 as jMG2
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as tR
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen as tMG
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from tests.helpers import sample_cases

B = 256
CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
BF16_TOL = 5e-3
SMALL = dict(
    w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48,
    nd_tier=16, nd_wide_div=4, dd_subbatch_div=3, split_planes=True,
)


def _cfg(mod, td_mode):
    return mod.Config(
        movegen=mod.MoveGenConfig(**SMALL),
        model=mod.ModelConfig(
            fused_actor_kernel=True, actor_tier_width=16, actor_tier_wide_div=4,
            dtype="bfloat16",
        ),
        train=mod.TrainConfig(td_mode=td_mode),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _state_to_port(js) -> tE.EnvState:
    js = jax.device_get(js)
    return tE.EnvState(
        board=tB.Board(_t(js.board.data)),
        **{k: _t(getattr(js, k)) for k in jE.EnvState._fields if k != "board"},
    )


def _leaves(x):
    """name -> numpy array for an EnvState / StepResult / Transition."""
    out = {}
    for k in x._fields:
        v = getattr(x, k)
        if hasattr(v, "_fields"):
            for k2, v2 in _leaves(v).items():
                out[f"{k}.{k2}"] = v2
        else:
            out[k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_leaves_equal(want, got, rows=None):
    lw, lg = _leaves(want), _leaves(got)
    assert set(lw) == set(lg)
    for k in lw:
        a, b = lw[k], lg[k]
        if rows is not None:
            a, b = a[rows], b[rows]
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# environment
# ---------------------------------------------------------------------------


def _midgame_state(seed):
    boards, players, dice = sample_cases(seed, B)
    data = np.array(
        [list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards], np.int8
    )
    # rows 0..7: player 0 bears off its last checker while player 1 has
    # borne off nothing and keeps a checker in player 0's home (backgammon)
    data[:8] = 0
    data[:8, 23] = 1
    data[:8, 50] = 14
    data[:8, 24 + 20] = 1
    data[:8, 24 + 5] = 14
    # rows 8..15: player 0 holds a five-prime on 12..16 with player 1 behind
    # it; rows 16..23: player 0 has closed its home board on player 1
    data[8:24] = 0
    data[8:16, 12:17] = 2
    data[8:16, 0] = 5
    data[8:16, 24 + 20 : 24 + 24] = [4, 4, 4, 3]
    data[16:24, 18:24] = 2
    data[16:24, 3] = 3
    data[16:24, 24 + 2] = 14
    data[16:24, 49] = 1
    players[:24] = [0] * 24
    rng = np.random.default_rng(seed)
    # some games near the step cap, to exercise truncation freezing
    steps = np.where(rng.random(B) < 0.1, 295, rng.integers(0, 100, B)).astype(np.int32)
    return jE.EnvState(
        board=jB.Board(jnp.asarray(data)),
        player=jnp.asarray(np.asarray(players, np.int32)),
        dice=jnp.asarray(np.asarray(dice, np.int32)),
        game_over=jnp.zeros(B, bool),
        win_type=jnp.zeros(B, jnp.int8),
        close_out_given=jnp.asarray((rng.random((B, 2)) < 0.2) & (np.arange(B) >= 24)[:, None]),
        prime_given=jnp.asarray((rng.random((B, 2)) < 0.2) & (np.arange(B) >= 24)[:, None]),
        step_count=jnp.asarray(steps),
    )


def test_reset_from_rolls_bit_exact():
    rng = np.random.default_rng(0)
    pairs = np.asarray(jE._ND_PAIRS)
    opener = pairs[rng.integers(0, 30, B)]
    first = pairs[rng.integers(0, 30, B)]
    want = jE.reset_from_rolls(jnp.asarray(opener), jnp.asarray(first))
    got = tE.reset_from_rolls(_t(opener), _t(first))
    _assert_leaves_equal(want, got)


def test_env_multistep_bit_exact():
    cfg = jcfg.Config().env
    tcf = tcfg.Config().env
    mg = jcfg.MoveGenConfig(**SMALL)
    moves_fn = jax.jit(lambda b, p, d: jMG2.legal_moves(b, p, d, mg))
    js = _midgame_state(5)
    ts = _state_to_port(js)
    rng = np.random.default_rng(5)
    seen = np.zeros(4, int)
    bonus = 0
    for i in range(30):
        ms = jax.device_get(moves_fn(js.board, js.player, js.dice))
        valid = np.asarray(ms.valid)
        # a uniformly random valid slot per game (slot 0 where none)
        score = np.where(valid, rng.random(valid.shape), -1.0)
        action = np.argmax(score, -1).astype(np.int32)
        next_dice = rng.integers(1, 7, (B, 2)).astype(np.int32)
        if i % 2:
            chosen = np.asarray(ms.boards.data)[np.arange(B), action]
            want = jE.step_chosen(
                js, ms.count, jB.Board(jnp.asarray(chosen)), jnp.asarray(next_dice), cfg
            )
            got = tE.step_chosen(
                ts, _t(ms.count), tB.Board(_t(chosen)), _t(next_dice), tcf
            )
        else:
            want = jE.step(js, ms, jnp.asarray(action), jnp.asarray(next_dice), cfg)
            tms = tMG.MoveSet(
                boards=tB.Board(_t(ms.boards.data)), valid=_t(valid), count=_t(ms.count)
            )
            got = tE.step(ts, tms, _t(action), _t(next_dice), tcf)
        _assert_leaves_equal(want, got)
        seen += np.bincount(np.asarray(want.win_type), minlength=4)
        bonus += int(np.sum(want.close_out_bonus) + np.sum(want.prime_bonus))
        # continuous-mode reset of finished games with JAX's own rolls
        key = jax.random.PRNGKey(100 + i)
        mask = want.done | (want.state.step_count >= cfg.max_timesteps)
        js = jE.reset_where(mask, want.state, key)
        k_start, k_first = jax.random.split(key)
        opener = jE.roll_nondouble(k_start, (B,))
        first = jE.roll_nondouble(k_first, (B,))
        ts = tE.reset_where(_t(mask), got.state, _t(opener), _t(first))
        _assert_leaves_equal(js, ts)
    # the sequence reached every win type and the shaping bonuses
    assert seen[1] > 0 and seen[2] > 0 and seen[3] > 0, seen
    assert bonus > 0


# ---------------------------------------------------------------------------
# rollout, teacher-forced
# ---------------------------------------------------------------------------


def _jax_step_fns(jparams, cfg, temp):
    tier = cfg.model.actor_tier_width
    wn = max(8, B // cfg.model.actor_tier_wide_div)
    W = max(cfg.movegen.a_max, cfg.movegen.nd_dedup_k)

    @jax.jit
    def step(st, key):
        return jR.rollout_step(jparams, st, key, temp, cfg, True)

    @jax.jit
    def noise_and_action(st, key):
        # the draws rollout_step makes, in its own key order
        k_act, k_roll, k_reset = jax.random.split(key, 3)
        k1, k2 = jax.random.split(k_act)
        k_start, k_first = jax.random.split(k_reset)
        noise = (
            jax.random.gumbel(k1, (B, tier)),
            jax.random.gumbel(k2, (wn, W)),
            jE.roll_dice(k_roll, (B,)),
            jE.roll_nondouble(k_start, (B,)),
            jE.roll_nondouble(k_first, (B,)),
        )
        sm = jMG2.legal_moves_split(st.board, st.player, st.dice, cfg.movegen)
        side0 = cfg.train.td_mode == "side0"
        cand_flag = (1 - st.player) if side0 else st.player
        sgn = jnp.where(st.player == 0, 1.0, -1.0) if side0 else None
        action, _, _ = jR._select_action_split(
            jparams, sm, cand_flag, sgn, k_act, temp, cfg
        )
        return noise, action

    return step, noise_and_action


def _port_action(tparams, ts, noise, cfg, temp):
    sm = tMG2.legal_moves_split(ts.board, ts.player, ts.dice, cfg.movegen)
    side0 = cfg.train.td_mode == "side0"
    cand_flag = (1 - ts.player) if side0 else ts.player
    sgn = torch.where(ts.player == 0, 1.0, -1.0) if side0 else None
    action, _, _ = tR._select_action_split(
        tparams, sm, cand_flag, sgn, noise.gumbel_t1, noise.gumbel_t2,
        torch.tensor(temp), cfg,
    )
    return action


@pytest.mark.parametrize("td_mode", ["reference", "side0"])
def test_rollout_step_teacher_forced(td_mode):
    jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jc, tc = _cfg(jcfg, td_mode), _cfg(tcfg, td_mode)
    temp = 0.7
    jstep, jnoise = _jax_step_fns(jparams, jc, jnp.float32(temp))
    # random mid-game and end-game positions: wins, passes, truncations and
    # continuous-mode resets all happen within the 24 steps
    js = _midgame_state(3)
    key = jax.random.PRNGKey(17)
    n_rows = n_agree = n_done = 0
    for _ in range(24):
        key, sub = jax.random.split(key)
        (g1, g2, nd, op, fi), jaction = jax.device_get(jnoise(js, sub))
        noise = tR.StepNoise(_t(g1), _t(g2), _t(nd), _t(op), _t(fi))
        ts = _state_to_port(js)
        taction = _port_action(tparams, ts, noise, tc, temp).numpy()
        agree = taction == np.asarray(jaction)
        n_rows += B
        n_agree += int(agree.sum())

        jnew, jt = jax.device_get(jstep(js, sub))
        tnew, tt = tR.rollout_step(
            tparams, ts, temp, tc, True, noise=noise, device="cpu"
        )
        lw, lg = _leaves(jt), _leaves(tt)
        for k in lw:
            if k == "value":
                assert np.max(np.abs(lw[k] - lg[k])) <= BF16_TOL
            else:
                np.testing.assert_array_equal(lw[k][agree], lg[k][agree], err_msg=k)
        _assert_leaves_equal(jnew, tnew, rows=agree)
        n_done += int(np.asarray(jt.done).sum())
        js = jnew  # teacher forcing: the next step starts from JAX's state
    print(f"td_mode={td_mode}: {n_rows - n_agree} disagreements in {n_rows} decisions")
    assert n_agree >= 0.999 * n_rows, (n_rows - n_agree, n_rows)
    assert n_done > 0


def test_rollout_loop_on_cpu_is_seeded_and_conserves_checkers():
    cfg = _cfg(tcfg, "side0")
    params = tV.init_params(cfg.model, torch.Generator().manual_seed(1), "cpu")
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(9)
        st = tE.reset(64, gen, device="cpu")
        st, traj = tR.rollout_loop(
            params, st, 1.0, cfg, 6, continuous=True, gen=gen, device="cpu"
        )
        runs.append((st, traj))
    (s1, t1), (s2, t2) = runs
    assert tuple(t1.packed_board.shape) == (6, 64, 52)
    assert t1.num_moves.dtype == torch.int32 and t1.packed_board.dtype == torch.int8
    _assert_leaves_equal(t1, t2)
    _assert_leaves_equal(s1, s2)
    assert bool(tB.checker_conservation_ok(s1.board).all())
    assert bool(tB.checker_conservation_ok(tB.Board(t1.packed_board)).all())


def test_rollout_step_rejects_unported_branches():
    """The tiered pipeline still raises; the merged 1-ply actor
    (tests/test_torch_train.py) and 2-ply (tests/test_torch_twoply*.py) are
    ported: their steps run, and the 2-ply step refuses the 1-ply noise
    type."""
    base = _cfg(tcfg, "reference")
    params = tV.init_params(base.model, device="cpu")
    st = tE.reset(16, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError):
        tiered = base.replace(movegen=dataclasses.replace(base.movegen, tiered=True))
        tR.rollout_step(params, st, 1.0, tiered, True, device="cpu")
    merged = base.replace(movegen=dataclasses.replace(base.movegen, split_planes=False))
    new, t = tR.rollout_step(params, st, 1.0, merged, True, gen=torch.Generator(), device="cpu")
    assert bool(t.recorded.any()) and bool(tB.checker_conservation_ok(new.board).all())
    twoply = base.replace(
        twoply=dataclasses.replace(base.twoply, enabled=True, reply_a_max=16)
    )
    gen = torch.Generator().manual_seed(1)
    new, t = tR.rollout_step(params, st, 1.0, twoply, True, gen=gen, device="cpu")
    assert tuple(t.num_moves.shape) == (16,) and bool(t.recorded.any())
    assert bool(tB.checker_conservation_ok(new.board).all())
    with pytest.raises(TypeError):
        tR.rollout_step(
            params, st, 1.0, twoply, True,
            noise=tR.draw_noise(16, base, gen, torch.device("cpu")), device="cpu",
        )
