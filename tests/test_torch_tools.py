"""The port's rules-parity and quality tools on the CPU.

* The rules stress (``scripts/stress_movegen2.py``): 2 batches of each
  configuration at the reduced widths of tests/test_split_planes.py and at
  the real ones with 0 mismatches, and a planted wrong move set reported
  with exit status 1.
* The 2-ply decision guard (``scripts/twoply_decision_guard.py``): its
  scoring of 64 seeded positions against the JAX package's ``legal_moves``
  -> ``oriented_values`` -> ``topk_small`` -> ``weighted_opponent_response``
  (each JAX config lowered in its own spawned interpreter, as
  tests/test_torch_twoply.py explains), seed-0 params carried across by
  ``params_from_jax``: the top-K slots equal, scores within rtol 1e-5, atol
  1e-6; the report's arithmetic on a hand-made score pair.
* The learning-curve sweep (``scripts/eval_curve.py``): its JSON schema, its
  win-rate formula, and the fixed-tensor loading that gives one graph key a
  side order for every checkpoint.
* The parity trainer (``scripts/run_parity_trainer.py``): 2 updates of 8
  games write ``ep*.pth`` that read back bitwise and a ``train.jsonl`` with
  the JAX script's keys.
"""
import dataclasses
import json
import multiprocessing
import pathlib

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.eval import arena
from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases
from mlp_ppo_2ply_multi_tpu_torch.scripts import eval_curve
from mlp_ppo_2ply_multi_tpu_torch.scripts import run_parity_trainer as parity
from mlp_ppo_2ply_multi_tpu_torch.scripts import stress_movegen2 as stress
from mlp_ppo_2ply_multi_tpu_torch.scripts import twoply_decision_guard as guard
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tests/test_split_planes.py's reduced widths
SMALL = dict(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, nd_tier=16, nd_wide_div=4,
             dd_subbatch_div=3, split_planes=True)
RTOL, ATOL = 1e-5, 1e-6
GUARD_N = 64


def _small_stress_configs():
    return {"a": (MoveGenConfig(**dict(SMALL, nd_tier=0, dd_subbatch_div=0,
                                       split_planes=False)), 0.35, False),
            "b": (MoveGenConfig(**SMALL), 0.0, True)}


def test_stress_small_widths_two_batches(monkeypatch):
    """At the reduced widths rows overflow; every row without the flag
    equals the oracle."""
    monkeypatch.setattr(stress, "configs", _small_stress_configs)
    reps = {name: stress.run(name, 2, "cpu", log=lambda s: None) for name in ("a", "b")}
    for rep in reps.values():
        assert rep["mismatches"] == 0 and rep["positions"] == 2 * stress.BATCH
    assert sum(r["overflow_rows"] for r in reps.values()) > 0


def test_stress_cli_two_batches(capsys):
    assert stress.main(["2", "--configs", "a", "b", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines.count("done: 256 positions, 0 mismatches") == 2
    reps = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["config"] for r in reps] == ["a", "b"]
    assert reps[0]["movegen"]["nd_dedup_k"] == 576 and reps[1]["split_planes"]


def test_stress_reports_a_planted_wrong_move_set(monkeypatch, capsys):
    """The oracle's move set of one position loses its last move: that
    position alone is reported, and the run exits 1."""
    real = stress.oracle_afterstates
    planted = []

    def wrong(board, player, dice):
        moves = real(board, player, dice)
        if not planted and len(moves) > 1:
            planted.append((board, player, tuple(dice)))
            return moves[:-1]
        return moves

    monkeypatch.setattr(stress, "oracle_afterstates", wrong)
    assert stress.main(["1", "--configs", "a", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("MISMATCH config a batch 0 game ") == 1
    assert f"board {planted[0][0]}" in out
    assert "done: 128 positions, 1 mismatches" in out


def _guard_inputs():
    boards, players, dice = sample_cases(31, GUARD_N, doubles_bias=0.2)
    packed = np.array([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
                      np.int8)
    return packed, np.asarray(players, np.int32), np.asarray(dice, np.int32)


def jax_guard_scores(tuned):
    """JAX ``_scores`` of scripts/twoply_decision_guard.py at the reduced
    widths with seed-0 params, on ``_guard_inputs``, in this (spawned)
    interpreter. Returns (params, top-K slots, scores) as numpy."""
    import jax
    import jax.numpy as jnp

    from mlp_ppo_2ply_multi_tpu.core import config as jcfg
    from mlp_ppo_2ply_multi_tpu.engine import board as jB
    from mlp_ppo_2ply_multi_tpu.engine.movegen import board_take, legal_moves
    from mlp_ppo_2ply_multi_tpu.model import value_net as jV
    from mlp_ppo_2ply_multi_tpu.twoply import expectimax as jX

    jax.config.update("jax_platforms", "cpu")
    tw = jcfg.TwoPlyConfig.tuned() if tuned else jcfg.TwoPlyConfig(enabled=True)
    cfg = jcfg.Config(twoply=tw, train=jcfg.TrainConfig(), movegen=jcfg.MoveGenConfig(**SMALL))
    params = jV.init_params(jax.random.PRNGKey(0), cfg.model)
    k = cfg.twoply.top_k_candidates

    @jax.jit
    def run(board, player, dice):
        moves = legal_moves(board, player, dice, cfg.movegen)
        v = jX.oriented_values(params, moves.boards, player[..., None], cfg)
        topv, topi = jX.topk_small(jnp.where(moves.valid, v, -1e9), k)
        top_valid = jnp.take_along_axis(moves.valid, topi, axis=-1)
        w_o = jX.weighted_opponent_response(params, board_take(moves.boards, topi),
                                            1 - player, cfg)
        return topi, jnp.where(top_valid, cfg.twoply.alpha * topv - cfg.twoply.beta * w_o, -1e9)

    packed, player, dice = _guard_inputs()
    topi, scores = run(jB.unpack_board(jnp.asarray(packed)), jnp.asarray(player),
                       jnp.asarray(dice))
    return {n: np.asarray(v) for n, v in params.items()}, np.asarray(topi), np.asarray(scores)


@pytest.fixture(scope="module", autouse=True)
def jax_guard_jobs():
    """Both JAX configs, one fresh interpreter each, started before the
    module's first test so that their compiles overlap the port-only tests."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2, maxtasksperchild=1) as pool:
        yield {name: pool.apply_async(jax_guard_scores, (name == "tuned",))
               for name in ("tuned", "exact")}


@pytest.fixture(scope="module")
def jax_guard(jax_guard_jobs):
    return {name: j.get(timeout=900) for name, j in jax_guard_jobs.items()}


def test_guard_report_arithmetic():
    neg = -1e9
    topi = np.tile(np.arange(4), (3, 1))
    exact = np.array([[1.0, 0.5, neg, neg], [0.2, 0.3, 0.1, 0.0], [0.4, 0.4, 0.1, 0.0]],
                     np.float32)
    tuned = exact.copy()
    tuned[1, 0] = 0.35  # the tuned scorer picks slot 0 where exact picks slot 1
    rep = guard.report(topi, tuned, topi, exact)
    assert set(rep) == set(json.loads((ROOT / "artifacts" / "twoply_decision_guard.json")
                                      .read_text()))
    assert rep["positions"] == 3 and rep["disagreements"] == 1
    assert rep["agreement"] == pytest.approx(2 / 3)
    assert rep["mean_regret"] == pytest.approx(0.1 / 3)
    assert rep["mean_regret_when_disagree"] == pytest.approx(0.1)
    assert rep["max_regret"] == pytest.approx(0.1)
    assert rep["score_delta_frac_nonzero"] == pytest.approx(0.1)  # 1 of 10 presented
    assert rep["score_delta_mean"] == pytest.approx(0.015)
    assert rep["score_delta_max"] == pytest.approx(0.15)
    same = guard.report(topi, exact, topi, exact)
    assert same["agreement"] == 1.0 and same["max_regret"] == 0.0
    with pytest.raises(AssertionError):
        guard.report(topi[:, ::-1], tuned, topi, exact)


def _run_dir(tmp_path):
    """One reference .pth at episode 0 and one port checkpoint at 8."""
    cfg = Config()
    gen = torch.Generator().manual_seed(3)
    value_net.save_checkpoint(value_net.init_params(cfg.model, gen, "cpu"),
                              str(tmp_path / "ep00000000.pth"))
    state = td.init_train_state(cfg, gen, "cpu")
    checkpoint.save(str(tmp_path), state._replace(episode_count=state.episode_count + 8), gen)
    return str(tmp_path)


def test_curve_schema_formula_and_one_graph_key(tmp_path, monkeypatch):
    run = _run_dir(tmp_path)
    assert [e for e, _, _ in eval_curve.checkpoints(run)] == [0, 8]
    small = Config(movegen=MoveGenConfig(**SMALL))
    keys = []
    real = arena.play_match

    def keyed(pa, pb, a, b, gen, cfg, batch, max_steps, device=None, **kw):
        keys.append(arena._graph_key(pa, pb, a, b, cfg, batch, 16, torch.device("cpu")))
        return real(pa, pb, a, b, gen, cfg, batch, max_steps, device=device, **kw)

    monkeypatch.setattr(arena, "play_match", keyed)
    curves, info = eval_curve.sweep([run], games=12, max_steps=96, device="cpu", cfg=small,
                                    log=lambda s: None)
    assert info["checkpoints"] == 2 and len(keys) == 4
    assert keys[0] == keys[2] and keys[1] == keys[3] and keys[0] != keys[1]
    for i, rec in enumerate(curves[run]):
        assert set(rec) == {"episodes", "win_rate_vs_random", "finished", "games"}
        w0, w1 = info["winners"][run][i]
        wins = int((w0 == 0).sum() + (w1 == 1).sum())
        finished = int((w0 >= 0).sum() + (w1 >= 0).sum())
        assert rec["games"] == 12 and rec["finished"] == finished
        assert rec["win_rate_vs_random"] == wins / max(finished, 1)
    assert sum(r["finished"] for r in curves[run]) > 0
    # the last checkpoint's winners, on freshly loaded params
    params = checkpoint.restore(run, "cpu")[0].params
    seed = eval_curve.SEED_STRIDE * 2
    res = real(params, params, arena.greedy_policy(small), arena.random_policy(small),
               torch.Generator().manual_seed(seed), small, 6, 96, device="cpu")
    assert torch.equal(res.winner, info["winners"][run][1][0])


def test_curve_cli_writes_the_artifact_schema(tmp_path):
    (tmp_path / "run").mkdir()
    run = _run_dir(tmp_path / "run")
    out = tmp_path / "curves.json"
    assert eval_curve.main([run, "--games", "4", "--max-steps", "4", "--device", "cpu",
                            "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    ref = json.loads((ROOT / "artifacts" / "curves_ours_tpu.json").read_text())
    assert list(got) == [run]
    assert [set(r) for r in got[run]] == [set(next(iter(ref.values()))[0])] * 2


def test_parity_trainer_two_updates(tmp_path):
    cfg = parity.parity_config(0)
    assert (cfg.train.batch_games, cfg.train.td_mode, cfg.train.rollout_mode) == (
        200, "reference", "sync") and cfg.train.per_episode_updates
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_games=8),
                      movegen=tcfg.MoveGenConfig(**dict(SMALL, split_planes=False)),
                      env=dataclasses.replace(cfg.env, max_timesteps=12))
    state = parity.run(cfg, 16, str(tmp_path), ckpt_every=8, device="cpu", log=lambda s: None)
    assert int(state.episode_count) == 16 and int(state.version) == 2
    assert sorted(p.name for p in tmp_path.glob("ep*.pth")) == [
        "ep00000000.pth", "ep00000008.pth", "ep00000016.pth"]
    last = value_net.load_checkpoint(str(tmp_path / "ep00000016.pth"), "cpu")
    assert all(torch.equal(last[k], state.params[k]) for k in state.params)
    first = value_net.load_checkpoint(str(tmp_path / "ep00000000.pth"), "cpu")
    assert not torch.equal(first["w1"], last["w1"])
    lines = [json.loads(x) for x in (tmp_path / "train.jsonl").read_text().splitlines()]
    ref = json.loads((ROOT / "artifacts" / "ourrun_s0_tpu_train.jsonl").read_text().splitlines()[0])
    assert [set(x) for x in lines] == [set(ref)] * 2
    assert [x["episodes"] for x in lines] == [8, 16] and [x["version"] for x in lines] == [1, 2]
    assert lines[0]["temperature"] == 1.5 and np.isfinite([x["loss"] for x in lines]).all()


@pytest.mark.parametrize("name", ["tuned", "exact"])
def test_guard_scores_match_jax(jax_guard, name):
    jparams, want_topi, want = jax_guard[name]
    cfg = guard.configs()[name == "exact"]
    assert cfg.twoply.reply_a_max == (96 if name == "tuned" else 128)
    cfg = cfg.replace(movegen=MoveGenConfig(**SMALL))
    params = value_net.params_from_jax(jparams, device="cpu")
    topi, scores = guard.score(params, *_guard_inputs(), cfg, "cpu")
    np.testing.assert_array_equal(topi, want_topi)
    np.testing.assert_allclose(scores, want, rtol=RTOL, atol=ATOL)
    assert (want > -1e8).sum() > GUARD_N
