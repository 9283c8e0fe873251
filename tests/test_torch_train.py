"""The port's training slice against the JAX package, on the CPU.

* Two teacher-forced train iterations (td_mode "side0", the f32 merged-moves
  actor): each is 8 continuous rollout steps from JAX's states with JAX's
  noise injected, then the fused update; the second rollout runs each
  package's own updated params. Integer transition fields are bit-equal,
  values within rtol 1e-5, decisions equal on every row of the first
  rollout and on every row of the second whose JAX top-two gap of
  logit + gumbel is at least 1e-4 (a 1e-7 difference in params can flip
  only a near-tie); params and the Adam state after both updates are held
  to tests/test_torch_learner.py's tolerances.
* The merged-moves ``select_action`` (unfused f32, fused full width, fused
  two-tier) with injected noise: actions equal, v_obs at rtol 1e-5 (atol
  1e-6 near 0, an f32 rounding of the net's O(1) hidden sums).
* ``build_config`` field for field, checkpoints, a sync-mode resume, the
  CLI smokes and the SIGTERM stop.
"""
import argparse
import dataclasses
import json
import math
import os
import pathlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.actor import rollout as jR
from mlp_ppo_2ply_multi_tpu.apps import train as jtrain
from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu.engine import movegen2 as jMG2
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.learner import td as jtd
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as tR
from mlp_ppo_2ply_multi_tpu_torch.apps import train as ttrain
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint as tckpt
from mlp_ppo_2ply_multi_tpu_torch.learner import td as ttd
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from tests.test_torch_learner import assert_states_close
from tests.test_torch_rollout import B, _leaves, _midgame_state, _state_to_port, _t
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
MERGED = dict(
    w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, dd_subbatch_div=3,
)
W = 64  # max(a_max, nd_dedup_k)
NEAR_TIE = 1e-4
STEPS = 8


def merged_cfg(mod, td_mode="side0", fused=False, tier=0):
    return mod.Config(
        movegen=mod.MoveGenConfig(**MERGED),
        model=mod.ModelConfig(fused_actor_kernel=fused, actor_tier_width=tier,
                              actor_tier_wide_div=4),
        train=mod.TrainConfig(td_mode=td_mode, per_episode_updates=False, batch_games=B),
    )


def jax_noise_fn(cfg):
    """The draws JAX's merged rollout_step makes from its key, in its own key
    order, JAX's action, and its top-two gap of logit + gumbel."""
    tier = cfg.model.actor_tier_width
    wn = max(8, B // cfg.model.actor_tier_wide_div)

    @jax.jit
    def fn(params, st, key, temp):
        k_act, k_roll, k_reset = jax.random.split(key, 3)
        k_start, k_first = jax.random.split(k_reset)
        if cfg.model.fused_actor_kernel and tier:
            k1, k2 = jax.random.split(k_act)
            g1, g2 = jax.random.gumbel(k1, (B, tier)), jax.random.gumbel(k2, (wn, W))
        else:
            g1, g2 = jax.random.gumbel(k_act, (B, W)), jnp.zeros((0, W))
        noise = (g1, g2, jE.roll_dice(k_roll, (B,)), jE.roll_nondouble(k_start, (B,)),
                 jE.roll_nondouble(k_first, (B,)))
        moves = jMG2.legal_moves(st.board, st.player, st.dice, cfg.movegen)
        action, v_obs, tier_ov = jR.select_action(params, st, moves, k_act, temp, cfg)
        gap = jnp.zeros((B,))
        if not cfg.model.fused_actor_kernel:
            side0 = cfg.train.td_mode == "side0"
            cand_flag = (1 - st.player) if side0 else st.player
            v = jV.forward(params, encode_board(moves.boards, cand_flag[..., None]), cfg.model)
            if side0:
                v = v * jnp.where(st.player == 0, 1.0, -1.0)[..., None]
            z = jnp.where(moves.valid, v / temp, -1e9) + g1
            top2 = jax.lax.top_k(z, 2)[0]
            gap = jnp.where(moves.count > 1, top2[:, 0] - top2[:, 1], jnp.inf)
        return noise, action, v_obs, tier_ov, gap

    return fn


def port_noise(noise):
    return tR.StepNoise(*(_t(x) for x in noise))


def np_params(params):
    return {k: np.asarray(v) for k, v in jax.device_get(params).items()}


# ---------------------------------------------------------------------------
# select_action
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused,tier", [(False, 0), (True, 0), (True, 16)],
                         ids=["unfused_f32", "fused_full_width", "fused_tiered"])
def test_select_action_matches_jax(fused, tier):
    jc, tc = merged_cfg(jcfg, fused=fused, tier=tier), merged_cfg(tcfg, fused=fused, tier=tier)
    assert tR._noise_shapes(B, tc) == ((tier, 64, W) if tier else (W, 0, W))
    jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.params_from_jax(np_params(jparams), "cpu")
    fn = jax_noise_fn(jc)
    js = _midgame_state(11)
    n_rows = n_wide = 0
    for i in range(3):
        noise, jaction, jv_obs, jtier_ov, _ = jax.device_get(
            fn(jparams, js, jax.random.PRNGKey(40 + i), jnp.float32(0.7)))
        ts = _state_to_port(js)
        moves = tMG2.legal_moves(ts.board, ts.player, ts.dice, tc.movegen)
        action, v_obs, tier_ov = tR.select_action(
            tparams, ts, moves, _t(noise[0]), _t(noise[1]), torch.tensor(0.7), tc)
        np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
        np.testing.assert_allclose(v_obs.numpy(), np.asarray(jv_obs), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tier_ov.numpy(), np.asarray(jtier_ov))
        n_rows += int((moves.count > 0).sum())
        n_wide += int((moves.count > 16).sum())
        js = js._replace(player=1 - js.player)  # the other side to move
    assert n_rows > 500 and (not tier or n_wide > 0)


# ---------------------------------------------------------------------------
# the slice as a whole: two teacher-forced train iterations
# ---------------------------------------------------------------------------


def test_two_teacher_forced_train_iterations_match_jax():
    jc, tc = merged_cfg(jcfg), merged_cfg(tcfg)
    js_train = jtd.init_train_state(jax.random.PRNGKey(4), jc)
    ts_train = ttd.train_state_from_jax(jax.device_get(js_train), "cpu")
    noise_fn = jax_noise_fn(jc)
    step_fn = jax.jit(lambda p, st, k, temp: jR.rollout_step(p, st, k, temp, jc, True))
    js = _midgame_state(3)
    key = jax.random.PRNGKey(17)
    near_ties = []
    for it in range(2):
        jtemp = jtd.temperature(js_train.version, jc)
        ttemp = ttd.temperature(ts_train.version, tc)
        assert float(ttemp) == float(jtemp)
        jts, tts = [], []
        n_dis = n_done = 0
        for _ in range(STEPS):
            key, sub = jax.random.split(key)
            noise, jaction, _, _, gap = jax.device_get(noise_fn(js_train.params, js, sub, jtemp))
            ts = _state_to_port(js)
            moves = tMG2.legal_moves(ts.board, ts.player, ts.dice, tc.movegen)
            taction, _, _ = tR.select_action(
                ts_train.params, ts, moves, _t(noise[0]), _t(noise[1]), ttemp, tc)
            agree = (taction.numpy() == np.asarray(jaction)) | (moves.count.numpy() == 0)
            if it == 0:
                assert agree.all()
            else:
                assert (np.asarray(gap)[~agree] < NEAR_TIE).all()
                near_ties.append(int((np.asarray(gap) < NEAR_TIE).sum()))
            n_dis += int((~agree).sum())
            jnew, jt = jax.device_get(step_fn(js_train.params, js, sub, jtemp))
            tnew, tt = tR.rollout_step(ts_train.params, ts, ttemp, tc, True,
                                       noise=port_noise(noise), device="cpu")
            lw, lg = _leaves(jt), _leaves(tt)
            for k in lw:
                if k == "value":
                    np.testing.assert_allclose(lg[k], lw[k], rtol=1e-5, atol=1e-7)
                else:
                    np.testing.assert_array_equal(lw[k][agree], lg[k][agree], err_msg=k)
            for k, v in _leaves(jnew).items():
                np.testing.assert_array_equal(v[agree], _leaves(tnew)[k][agree], err_msg=k)
            n_done += int(np.asarray(jt.done).sum())
            jts.append(jt)
            tts.append(tt)
            js = jnew  # teacher forcing: both rollouts continue from JAX's state
        assert n_done > 0
        jtraj = jax.tree.map(lambda *xs: jnp.stack(xs), *jts)
        ttraj = tR.Transition(*(torch.stack(xs) for xs in zip(*tts)))
        js_train, jm = jtd.update(js_train, jtraj, jc)
        ts_train, tm = ttd.update(ts_train, ttraj, tc, "cpu")
        for k in ("loss", "grad_norm", "td_abs", "v_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        print(f"iteration {it}: {n_dis} disagreements, near-ties per step {near_ties}")
    assert_states_close(js_train, ts_train)
    assert int(ts_train.version) == 2 and int(ts_train.episode_count) == 2 * B


# ---------------------------------------------------------------------------
# CLI, config, checkpoints
# ---------------------------------------------------------------------------


def _ns(**kw):
    base = dict(
        batch_games=8, per_episode_updates=False, td_mode="reference", mode="continuous",
        seed=0, checkpoint_every=50_000, checkpoint_dir="c", metrics_dir="m",
        small_movegen=False, production=False, max_timesteps=None, full_widths=False,
        tiered=False, two_ply=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("flags", [
    {}, {"production": True}, {"production": True, "full_widths": True},
    {"small_movegen": True}, {"two_ply": True}, {"two_ply": True, "production": True},
    {"max_timesteps": 40, "small_movegen": True, "mode": "sync", "td_mode": "side0",
     "per_episode_updates": True, "seed": 3, "batch_games": 64},
    {"tiered": True}, {"tiered": True, "production": True},
    {"tiered": True, "small_movegen": True}, {"tiered": True, "two_ply": True},
], ids=lambda f: "-".join(f) or "default")
def test_build_config_matches_jax(flags):
    want = dataclasses.asdict(jtrain.build_config(_ns(**flags)))
    got = dataclasses.asdict(ttrain.build_config(_ns(**flags)))
    assert got == want


def test_checkpoint_round_trip_bitwise_and_pruned(tmp_path):
    cfg = tcfg.Config()  # per-episode updates: three Adam steps
    gen = torch.Generator().manual_seed(5)
    state = ttd.init_train_state(cfg, gen, "cpu")
    traj = tR.Transition(*(torch.from_numpy(np.asarray(v)) for v in _tiny_traj().values()))
    state, _ = ttd.update(state, traj, cfg, "cpu")
    torch.rand(3, generator=gen)  # a generator state away from its seed
    d = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, "cpu")
    os.makedirs(d)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, "cpu")
    for ec in range(1, 8):
        step = tckpt.save(d, state._replace(episode_count=torch.tensor(ec)), gen)
        assert step == ec
    assert tckpt.steps(d) == [3, 4, 5, 6, 7]
    got, gen_state, step = tckpt.restore(d, "cpu")
    assert step == 7 and int(got.episode_count) == 7 and int(got.version) == 1
    assert torch.equal(gen_state, gen.get_state())
    assert int(got.opt_state.count) == 3
    for a, b in zip(_flat(state._replace(episode_count=torch.tensor(7))), _flat(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back = torch.Generator()
    back.set_state(gen_state)
    assert torch.equal(torch.rand(4, generator=back), torch.rand(4, generator=gen))
    p = str(tmp_path / "model.pth")
    tckpt.export_torch(state, p)
    for k, v in tckpt.import_torch(p, "cpu").items():
        assert torch.equal(v, state.params[k])


def _flat(state):
    out = []
    ttd.map_state(out.append, state)
    return out


def _tiny_traj(T=6, Bt=3):
    from tests.test_torch_learner import np_traj

    return np_traj(2, T, Bt)


def _cli(tmp_path, *flags, run="run"):
    return ttrain.main([
        "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
        "--metrics-dir", str(tmp_path / run), "--log-every", "1", *flags,
    ])


def _records(tmp_path, run="run"):
    (name,) = os.listdir(tmp_path / run)
    lines = open(tmp_path / run / name / "metrics.jsonl").read().splitlines()
    recs = [json.loads(line) for line in lines]
    return [r for r in recs if "hist" not in r], [r for r in recs if "hist" in r]


def test_train_cli_sync_smoke(tmp_path):
    rc = _cli(tmp_path, "--mode", "sync", "--batch-games", "8", "--updates", "2",
              "--small-movegen", "--max-timesteps", "16")
    assert rc == 0
    scalars, hists = _records(tmp_path)
    assert len(scalars) == 2
    assert all(np.isfinite(r["loss"]) for r in scalars)
    assert all("width_overflow_count" in r for r in scalars)
    assert len(hists) == 2 * 4 and all("mean" in r for r in hists)
    assert [r["step"] for r in scalars] == [8, 16]
    assert tckpt.steps(str(tmp_path / "ck")) == [16]


def test_train_cli_continuous_production_smoke(tmp_path):
    rc = _cli(tmp_path, "--mode", "continuous", "--production", "--td-mode", "side0",
              "--batch-games", "16", "--updates", "2", "--steps-per-update", "4",
              "--histograms-every", "1", "--checkpoint-every", "1")
    assert rc == 0
    scalars, hists = _records(tmp_path)
    assert len(scalars) == 2 and len(hists) == 2 * 4
    assert all(np.isfinite(r["loss"]) and "width_overflow_count" in r for r in scalars)
    assert scalars[0]["temperature"] == 1.5
    state, _, step = tckpt.restore(str(tmp_path / "ck"), "cpu")
    assert step == 32 and int(state.version) == 2


def test_sync_resume_repeats_an_uninterrupted_run(tmp_path):
    flags = ["--mode", "sync", "--batch-games", "4", "--small-movegen",
             "--max-timesteps", "12", "--per-episode-updates", "--td-mode", "side0"]
    straight, split = tmp_path / "straight", tmp_path / "split"
    assert _cli(straight, *flags, "--updates", "2") == 0
    assert _cli(split, *flags, "--updates", "1", run="run1") == 0
    assert _cli(split, *flags, "--updates", "1", "--resume", run="run2") == 0
    a, _, sa = tckpt.restore(str(straight / "ck"), "cpu")
    b, _, sb = tckpt.restore(str(split / "ck"), "cpu")
    assert sa == sb == 8 and int(b.version) == 2 and int(b.opt_state.count) == 8
    for x, y in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y)
    clock = ("t", "eps_per_sec", "env_steps_per_sec")
    line_a = _records(straight)[0][1]
    (line_b,) = _records(split, "run2")[0]
    assert {k: v for k, v in line_a.items() if k not in clock} == {
        k: v for k, v in line_b.items() if k not in clock}


def test_sigterm_leaves_a_final_checkpoint(tmp_path, monkeypatch):
    real = ttd.update

    def update_then_signal(*args, **kw):
        out = real(*args, **kw)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(ttd, "update", update_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    rc = _cli(tmp_path, "--mode", "continuous", "--batch-games", "8", "--updates", "5",
              "--steps-per-update", "4", "--small-movegen")
    assert rc == 0 and signal.getsignal(signal.SIGTERM) is before
    state, _, step = tckpt.restore(str(tmp_path / "ck"), "cpu")
    assert int(state.version) == 1 and step == 8
    assert len(_records(tmp_path)[0]) == 1


def test_train_cli_refuses_unported_flags(tmp_path, capsys):
    """--data/--model run on a mesh of that many ranks, so at world 1 they
    exit 2 naming the world size, and --model above 1 with the fused kernel
    exits 2 naming it; --tiered runs
    (``test_train_cli_tiered_runs_one_update``) and turns the fused kernel
    on, so with --model 2 it exits 2 naming the kernel (--fused-rollout and
    --remote-dir run: tests/test_torch_parallel.py,
    tests/test_torch_remote.py)."""
    for flags, reason in ((["--data", "2"], "world has 1"), (["--model", "2"], "world has 1"),
                          (["--model", "2", "--production"], "fused actor kernel"),
                          (["--tiered", "--model", "2"], "fused actor kernel")):
        with pytest.raises(SystemExit) as e:
            _cli(tmp_path, *flags)
        assert e.value.code == 2
        assert reason in capsys.readouterr().err
    assert not (tmp_path / "run").exists()


def test_train_cli_tiered_runs_one_update(tmp_path, monkeypatch):
    """``apps.train --tiered --device cpu`` trains through the tiered
    pipeline: one update, a finite loss, every step's moves from
    ``legal_moves_tiered``."""
    from mlp_ppo_2ply_multi_tpu_torch.experimental import tiered as txt

    calls = []
    real = txt.legal_moves_tiered
    monkeypatch.setattr(txt, "legal_moves_tiered",
                        lambda *a: calls.append(1) or real(*a))
    rc = _cli(tmp_path, "--tiered", "--small-movegen", "--batch-games", "16",
              "--updates", "1", "--steps-per-update", "4")
    assert rc == 0 and len(calls) == 4
    (line,), _ = _records(tmp_path)
    assert math.isfinite(line["loss"])


def test_merged_rollout_loop_on_cpu_conserves_checkers():
    cfg = merged_cfg(tcfg, td_mode="reference", fused=True, tier=16)
    params = tV.init_params(cfg.model, torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    st, traj = tR.rollout_loop(params, tE.reset(64, gen, "cpu"), 1.0, cfg, 4,
                               continuous=True, gen=gen, device="cpu")
    assert tuple(traj.packed_board.shape) == (4, 64, 52) and bool(traj.recorded.any())
    assert bool(tB.checker_conservation_ok(st.board).all())
