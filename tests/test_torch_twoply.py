"""The port's 2-ply step against the JAX package on the f32 value path.

Teacher-forced: every step starts from the JAX state. The JAX step runs as
one jitted ``rollout_step``, in a fresh interpreter (``teacher_forced`` says
why); while it is traced, ``select_action_2ply`` and
``weighted_opponent_response`` are wrapped so that the merged legal moves,
the top-k candidate boards, their expected opponent responses and the
actions come out of the same compiled step. The noise that
``jax.random.categorical``/``roll_dice``/``reset_where`` draw inside the step
is derived from the same key and injected into the port.

Tolerances: integer results (legal moves, transitions, next state) are
bit-exact; f32 scores at rtol 1e-5 (the same f32 function, summed in another
order); decisions identical (0 disagreements expected; a disagreement must
be a near-tie of the sampled logits).
"""
import dataclasses
import functools
import multiprocessing
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.actor import rollout as jR
from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu.twoply import expectimax as jX
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as tR
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax as tX
from tests.helpers import sample_cases

CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
SMALL = dict(
    w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48,
    nd_tier=16, nd_wide_div=4, dd_subbatch_div=3, split_planes=True,
)
RTOL = 1e-5
NEAR_TIE = 1e-4
B = 24
STEPS = 4
TEMP = 0.7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU side runs small tensors: one intra-op thread keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twoply_cfg(mod, td_mode, fused, **twoply):
    """The production 2-ply structure (tuned per-die doubles widths) at the
    reduced widths of the engine tests."""
    tw = dict(
        enabled=True, reply_a_max=32,
        dd_reply_widths=((16, 32, 32, 32),) * 3 + ((16, 32, 48, 48),) * 3,
    )
    tw.update(twoply)
    return mod.Config(
        movegen=mod.MoveGenConfig(**SMALL),
        model=mod.ModelConfig(
            fused_actor_kernel=fused, actor_tier_width=16, actor_tier_wide_div=4,
            dtype="bfloat16" if fused else "float32",
        ),
        train=mod.TrainConfig(td_mode=td_mode),
        twoply=mod.TwoPlyConfig(**tw),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def start_state(seed, n):
    """Sampled mid-game and bear-off positions, some near the step cap."""
    boards, players, dice = sample_cases(seed, n, 0.2)
    data = np.array(
        [list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards], np.int8
    )
    rng = np.random.default_rng(seed)
    steps = np.where(rng.random(n) < 0.1, 298, rng.integers(0, 100, n)).astype(np.int32)
    return jE.EnvState(
        board=jB.Board(jnp.asarray(data)),
        player=jnp.asarray(np.asarray(players, np.int32)),
        dice=jnp.asarray(np.asarray(dice, np.int32)),
        game_over=jnp.zeros(n, bool),
        win_type=jnp.zeros(n, jnp.int8),
        close_out_given=jnp.zeros((n, 2), bool),
        prime_given=jnp.zeros((n, 2), bool),
        step_count=jnp.asarray(steps),
    )


def state_to_port(js) -> tE.EnvState:
    js = jax.device_get(js)
    return tE.EnvState(
        board=tB.Board(_t(js.board.data)),
        **{k: _t(getattr(js, k)) for k in jE.EnvState._fields if k != "board"},
    )


def leaves(x):
    out = {}
    for k in x._fields:
        v = getattr(x, k)
        if hasattr(v, "_fields"):
            out.update({f"{k}.{k2}": v2 for k2, v2 in leaves(v).items()})
        else:
            out[k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "n"))
def jax_step_with_parts(jparams, st, key, cfg, n):
    """JAX's ``rollout_step``, jitted, that also returns the step's noise,
    the merged legal moves, the candidate boards, their E[opponent response]
    and the actions (captured while the step is traced)."""
    k = cfg.twoply.top_k_candidates
    W = max(cfg.movegen.a_max, cfg.movegen.nd_dedup_k)
    seen = {}
    sel0, wor0 = jX.select_action_2ply, jX.weighted_opponent_response

    def sel(params, state, moves, key, temperature, cfg):
        seen["moves"] = moves
        out = sel0(params, state, moves, key, temperature, cfg)
        seen["action"] = out[0]
        return out

    def wor(params, boards, opp, cfg, return_flags=False):
        out = wor0(params, boards, opp, cfg, return_flags)
        seen["cand"], seen["w_o"] = boards.data, out
        return out

    jX.select_action_2ply, jX.weighted_opponent_response = sel, wor
    try:
        new, t = jR.rollout_step(jparams, st, key, jnp.float32(TEMP), cfg, True)
    finally:
        jX.select_action_2ply, jX.weighted_opponent_response = sel0, wor0
    # the draws rollout_step makes, in its own key order
    k_act, k_roll, k_reset = jax.random.split(key, 3)
    k2, k1 = jax.random.split(k_act)
    k_start, k_first = jax.random.split(k_reset)
    noise = (
        jax.random.gumbel(k2, (n, k)),
        jax.random.gumbel(k1, (n, W)),
        jE.roll_dice(k_roll, (n,)),
        jE.roll_nondouble(k_start, (n,)),
        jE.roll_nondouble(k_first, (n,)),
    )
    return new, t, noise, seen["moves"], seen["cand"], seen["w_o"], seen["action"]


def jax_rollout(td_mode, fused, seed, n, steps, twoply):
    """The JAX side of ``teacher_forced``: per step (state before, then what
    ``jax_step_with_parts`` returns), as numpy."""
    jax.config.update("jax_platforms", "cpu")
    jparams = jV.load_torch_checkpoint(CKPT)
    jc = twoply_cfg(jcfg, td_mode, fused, **twoply)
    js = start_state(seed, n)
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        parts = jax.device_get(jax_step_with_parts(jparams, js, sub, jc, n))
        out.append((jax.device_get(js), *parts))
        js = parts[0]  # teacher forcing
    return out


def teacher_forced(td_mode, fused, seed, n, steps, **twoply):
    """Run the JAX step and the port side by side for ``steps`` steps; per
    step a dict of both sides' results.

    The JAX side runs in a fresh interpreter: lowering JAX's 2-ply step a
    second time in one process, at another batch or config, gives a program
    that expects ~80 extra inputs and fails to run (seen with JAX 0.9 on the
    CPU, the package's own ``_jit_step`` included), and the test workers may
    run both 2-ply files in one process."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        jax_steps = pool.apply_async(
            jax_rollout, (td_mode, fused, seed, n, steps, twoply)
        ).get(timeout=900)
    jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    tc = twoply_cfg(tcfg, td_mode, fused, **twoply)
    temp = torch.tensor(TEMP)
    out = []
    for js, jnew, jt, jnoise, jmoves, jcand, jw_o, jaction in jax_steps:
        ts = state_to_port(js)
        noise = tR.TwoPlyNoise(*(_t(x) for x in jnoise))
        tmoves = tMG2.legal_moves(ts.board, ts.player, ts.dice, tc.movegen)
        tw_o = tX.weighted_opponent_response(
            tparams, tB.Board(_t(jcand)), 1 - ts.player, tc
        )
        taction, _ = tX.select_action_2ply(
            tparams, ts, tmoves, noise.gumbel_2ply, noise.gumbel_1ply, temp, tc
        )
        tnew, tt = tR.rollout_step(tparams, ts, TEMP, tc, True, noise=noise, device="cpu")
        out.append(dict(
            jmoves=jmoves, tmoves=tmoves, jw_o=np.asarray(jw_o), tw_o=tw_o.numpy(),
            jaction=np.asarray(jaction), taction=taction.numpy(), jt=jt, tt=tt,
            jnew=jnew, tnew=tnew, ts=ts, noise=noise, tparams=tparams, tc=tc,
        ))
    return out


def near_tie_rows(step, rows):
    """For rows where the decisions differ: the gap between the two chosen
    entries' sampled logits (logit + Gumbel) in the port's own scores."""
    if not len(rows):
        return []
    ts, noise = step["ts"], step["noise"]
    s = tX.sampled_logits_2ply(
        step["tparams"], ts, step["tmoves"], noise.gumbel_2ply, noise.gumbel_1ply,
        torch.tensor(TEMP), step["tc"],
    )
    return [
        tX.sampled_gap(s, int(r), int(step["jaction"][r]), int(step["taction"][r]))
        for r in rows
    ]


@pytest.fixture(scope="module")
def f32_run():
    return teacher_forced("reference", False, 11, B, STEPS)


def test_merged_legal_moves_along_a_2ply_rollout(f32_run):
    for i, s in enumerate(f32_run):
        jm, tm = s["jmoves"], s["tmoves"]
        for f in ("valid", "count", "overflow"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jm, f)), getattr(tm, f).numpy(), err_msg=f"step {i} {f}"
            )
        m = np.asarray(jm.valid)
        np.testing.assert_array_equal(
            np.asarray(jm.boards.data)[m], tm.boards.data.numpy()[m], err_msg=f"step {i}"
        )


def test_weighted_opponent_response_f32(f32_run):
    for i, s in enumerate(f32_run):
        assert s["tw_o"].shape == (B, 4) and s["tw_o"].dtype == np.float32
        np.testing.assert_allclose(s["tw_o"], s["jw_o"], rtol=RTOL, atol=1e-7, err_msg=f"step {i}")
    assert np.abs(np.concatenate([s["jw_o"] for s in f32_run])).max() > 0.1


def test_select_action_2ply_f32_decisions(f32_run):
    n_dis = 0
    for s in f32_run:
        rows = np.nonzero(s["jaction"] != s["taction"])[0]
        n_dis += len(rows)
        gaps = near_tie_rows(s, rows)
        assert all(g < NEAR_TIE for g in gaps), gaps
    print(f"f32: {n_dis} disagreements in {B * STEPS} decisions")
    # the 2-ply rerank decided most rows (>= 4 legal moves)
    counts = np.concatenate([s["tmoves"].count.numpy() for s in f32_run])
    assert (counts >= 4).mean() > 0.5


def test_sampled_logits_give_the_step_decisions(f32_run):
    """The argmax of ``sampled_logits_2ply`` is ``select_action_2ply``'s
    action, and ``sampled_gap`` reads that draw."""
    s = f32_run[0]
    ts, noise = s["ts"], s["noise"]
    sl = tX.sampled_logits_2ply(
        s["tparams"], ts, s["tmoves"], noise.gumbel_2ply, noise.gumbel_1ply,
        torch.tensor(TEMP), s["tc"],
    )
    pick = torch.gather(sl.cand, -1, sl.rerank.argmax(-1, keepdim=True))[:, 0]
    action = torch.where(sl.use_2ply, pick, sl.one_ply.argmax(-1))
    np.testing.assert_array_equal(action.numpy(), s["taction"])
    r = int(torch.nonzero(sl.use_2ply)[0, 0])
    a, b = int(sl.cand[r, 0]), int(sl.cand[r, 1])
    assert tX.sampled_gap(sl, r, a, a) == 0.0
    gap = abs(float(sl.rerank[r, 0] - sl.rerank[r, 1]))
    assert tX.sampled_gap(sl, r, a, b) == gap > 0
    outside = next(i for i in range(sl.one_ply.shape[-1]) if i not in sl.cand[r].tolist())
    assert tX.sampled_gap(sl, r, a, outside) == np.inf


def test_rollout_step_2ply_teacher_forced_f32(f32_run):
    done = 0
    for i, s in enumerate(f32_run):
        agree = s["jaction"] == s["taction"]
        lw, lg = leaves(s["jt"]), leaves(s["tt"])
        for k in lw:
            if k == "value":
                np.testing.assert_allclose(lg[k], lw[k], rtol=RTOL, atol=1e-6)
            else:
                np.testing.assert_array_equal(lw[k][agree], lg[k][agree], err_msg=f"{i} {k}")
        ln, lt = leaves(s["jnew"]), leaves(s["tnew"])
        for k in ln:
            np.testing.assert_array_equal(ln[k][agree], lt[k][agree], err_msg=f"{i} {k}")
        done += int(np.asarray(s["jt"].done).sum())
        assert bool(tB.checker_conservation_ok(s["tnew"].board).all())
    assert done > 0  # bear-off positions finish games within the steps


def test_topk_small_ties_match_jax():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 4, (64, 12)).astype(np.float32)  # many exact ties
    v[:8] = -1e9  # rows with nothing valid
    v[8:16, :3] = 2.0
    for k in (1, 4, 5):
        jv, ji = jax.device_get(jX.topk_small(jnp.asarray(v), k))
        tv, ti = tX.topk_small(torch.from_numpy(v), k)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    # earlier index first among equals
    _, ti = tX.topk_small(torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]]), 3)
    assert ti.tolist() == [[1, 2, 4]]


def test_rollout_loop_2ply_on_cpu_is_seeded_and_conserves_checkers():
    cfg = twoply_cfg(tcfg, "side0", True)
    params = tV.init_params(cfg.model, torch.Generator().manual_seed(2), "cpu")
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(4)
        st = tE.reset(16, gen, device="cpu")
        runs.append(tR.rollout_loop(params, st, 1.0, cfg, 3, continuous=True, gen=gen, device="cpu"))
    (s1, t1), (s2, t2) = runs
    assert tuple(t1.packed_board.shape) == (3, 16, 52)
    for a, b in zip(leaves(t1).values(), leaves(t2).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(leaves(s1).values(), leaves(s2).values()):
        np.testing.assert_array_equal(a, b)
    assert bool(tB.checker_conservation_ok(s1.board).all())
    assert bool((t1.num_moves > 0).any())


def test_scan_scorer_and_value_first_raise():
    """The scan scorer and the value-first replies used to raise; they run
    now (held to JAX in tests/test_torch_twoply_scan.py): finite scores of
    the candidates' shape, and at the uniform reply widths the scan at
    chunk 1 equals the unrolled scorer bit for bit."""
    cfg = twoply_cfg(tcfg, "side0", False, dd_reply_widths=())
    params = tV.init_params(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    boards = tB.initial_board((2, 4), "cpu")
    opp = torch.zeros(2, dtype=torch.int32)
    unrolled = tX.weighted_opponent_response(params, boards, opp, cfg)
    for tw in (
        dataclasses.replace(cfg.twoply, unroll_rolls=False),
        dataclasses.replace(cfg.twoply, roll_chunk=3),
        dataclasses.replace(cfg.twoply, value_first_m=16),
    ):
        w, flags = tX.weighted_opponent_response(
            params, boards, opp, cfg.replace(twoply=tw), return_flags=True)
        assert w.shape == (2, 4) and flags.shape == (2, 4)
        assert bool(torch.isfinite(w).all()) and not bool(flags.any())
        if not tw.unroll_rolls:
            assert torch.equal(w, unrolled)
        else:
            torch.testing.assert_close(w, unrolled, rtol=RTOL, atol=1e-6)
