"""The port's play and evaluate CLIs and their runtime pieces against the
JAX package's, on the CPU.

* The oracle copies (``oracle/rules.py``, ``oracle/env.py``) give the JAX
  package's full moves and transitions on positions sampled with the
  port's ``oracle/sampling.py`` (which ``tests/test_torch_sampling.py``
  holds equal to JAX's).
* ``render`` and ``describe_move`` give the same strings.
* ``forward_np`` and the play CLI's agent give JAX's values and actions; the
  port's batch-1 engine (``--engine torch``) presents the oracle's move set
  and picks its argmax (as ``tests/test_apps.py`` checks JAX's engine).
* The evaluate CLI plays on the CPU, loads a ``.pth`` and a port
  ``ckpt_<step>.pt``, and refuses an orbax directory with exit status 2.
"""
import json
import pathlib
import random

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.apps import play as jplay
from mlp_ppo_2ply_multi_tpu.apps import render as jrender
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu.oracle import env as jenv
from mlp_ppo_2ply_multi_tpu.oracle import rules as jrules
from mlp_ppo_2ply_multi_tpu_torch.apps import evaluate, play, render
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.oracle import env as tenv
from mlp_ppo_2ply_multi_tpu_torch.oracle import rules as trules
from mlp_ppo_2ply_multi_tpu_torch.oracle import sampling

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "checkpoints" / "side0_20480000.pth")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _positions(seed, n):
    rng = random.Random(seed)
    return [
        (sampling.random_board(rng), rng.randint(0, 1), sampling.random_roll(rng, 0.3))
        for _ in range(n)
    ]


def test_oracle_rules_copy_gives_the_same_moves_and_features():
    for board, player, roll in _positions(0, 300):
        want = jrules.full_moves(board, player, list(roll))
        got = trules.full_moves(board, player, list(roll))
        assert got == want
        assert trules.encode(board, player) == jrules.encode(board, player)
    assert trules.start_board() == jrules.start_board()


def test_oracle_env_copy_gives_the_same_transitions():
    for seed in range(6):
        rng = random.Random(seed)
        rolls = [(rng.randint(1, 6), rng.randint(1, 6)) for _ in range(400)]
        a, b = jenv.OracleEnv(iter(rolls)), tenv.OracleEnv(iter(rolls))
        assert a.reset() == b.reset()
        pick = random.Random(100 + seed)
        for _ in range(300):
            if a.game_over:
                break
            assert (a.board, a.player, a.roll, a.legal) == (b.board, b.player, b.roll, b.legal)
            act = None if a.num_moves == 0 else pick.randrange(a.num_moves)
            assert a.step(act) == b.step(act)
        assert (a.board, a.game_over, a.win_type) == (b.board, b.game_over, b.win_type)


def test_render_and_describe_move_give_the_jax_strings():
    for board, player, roll in _positions(1, 40):
        assert render.render(board, player, roll) == jrender.render(board, player, roll)
        assert render.render(board, player) == jrender.render(board, player)
        for mv, _ in trules.full_moves(board, player, list(roll))[:5]:
            assert render.describe_move(mv) == jrender.describe_move(mv)
    assert render.describe_move(((24, 19, False), (12, 9, True))) == "bar/20 13/10*"
    assert render.describe_move(()) == "(pass)"


def _numpy_params():
    return {k: np.asarray(v) for k, v in jV.load_torch_checkpoint(CKPT).items()}


def test_forward_np_and_play_agent_match_jax():
    p = _numpy_params()
    x = np.random.default_rng(0).random((33, 198), dtype=np.float32)
    np.testing.assert_array_equal(value_net.forward_np(p, x), jV.forward_np(p, x))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    np.testing.assert_array_equal(value_net.forward_np(tp, x), jV.forward_np(p, x))
    rolls = [(5, 2), (6, 1), (3, 4), (2, 2), (6, 6), (4, 1)] * 20
    a, b = jenv.OracleEnv(iter(rolls)), tenv.OracleEnv(iter(rolls))
    a.reset(), b.reset()
    pick = random.Random(3)
    checked = 0
    for _ in range(40):
        if a.game_over:
            break
        if a.num_moves:
            np.testing.assert_array_equal(play.move_values(p, b), jplay.move_values(p, a))
            for two_ply in (False, True) if checked < 3 else (False,):
                assert play.agent_action(p, b, two_ply) == jplay.agent_action(p, a, two_ply)
            checked += 1
        act = None if a.num_moves == 0 else pick.randrange(a.num_moves)
        a.step(act), b.step(act)
    assert checked >= 10


def test_torch_engine_matches_the_oracle():
    """--engine torch: the port's batched engine at batch 1 presents the
    oracle's move set and picks the oracle move whose value is its max."""
    p = _numpy_params()
    eng = play.TorchEngine(p, "cpu")
    env = tenv.OracleEnv(iter([(5, 2), (6, 1), (3, 4), (2, 2), (6, 6), (4, 4)] * 100))
    env.reset()
    rng = random.Random(7)
    checked = 0
    for _ in range(30):
        if env.game_over:
            break
        if env.num_moves == 0:
            env.step(None)
            continue
        a = eng.agent_action(env)
        assert 0 <= a < env.num_moves
        v_oracle = play.move_values(p, env)
        boards, v_eng = eng.move_values(env)
        assert sorted(boards) == sorted(b for _, b in env.legal)
        np.testing.assert_allclose(float(v_oracle[a]), float(np.max(v_eng)), rtol=1e-5)
        assert a == int(np.argmax(v_oracle))
        checked += 1
        env.step(rng.randrange(env.num_moves))
    assert checked >= 10


def test_play_cli_games_are_the_same_with_either_engine(monkeypatch, capsys):
    """A whole piped game (the human always takes move 0): the agent plays
    the same moves through the oracle and through the port's engine."""
    lines = []
    for engine in ("oracle", "torch"):
        moves = iter(["0"] * 400)
        monkeypatch.setattr("builtins.input", lambda prompt="": next(moves))
        rc = play.main(["--engine", engine, "--device", "cpu", "--seed", "7", "--show-values",
                        "--checkpoint", CKPT])
        out = capsys.readouterr().out
        assert rc == 0 and "game over" in out
        lines.append([l for l in out.splitlines() if l.startswith("agent plays")])
    assert len(lines[0]) > 5 and lines[0] == lines[1]


def _run_evaluate(args, capsys):
    rc = evaluate.main(["--device", "cpu", "--small-movegen", *args])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_evaluate_cli_on_the_cpu(capsys):
    rc, out = _run_evaluate(["--opponent", "random", "--games", "16", "--max-steps", "120",
                             "--checkpoint", CKPT, "--td-mode", "side0"], capsys)
    assert rc == 0
    assert out["games"] == 16
    assert set(out) == {"games", "finished", "win_rate_a", "win_rate_b", "unfinished",
                        "gammons", "backgammons"}
    assert out["finished"] > 0 and out["finished"] + out["unfinished"] == 16


def test_evaluate_loads_port_checkpoints_and_refuses_orbax(tmp_path, capsys):
    cfg = Config()
    state = td.init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    checkpoint.save(str(tmp_path / "ck"), state, torch.Generator().manual_seed(2), step=7)
    path = tmp_path / "ck" / "ckpt_7.pt"
    dev = torch.device("cpu")
    for src in (str(path), str(tmp_path / "ck")):
        got = evaluate._load(src, cfg, dev)
        for k in state.params:
            assert torch.equal(got[k], state.params[k])
    pth = evaluate._load(CKPT, cfg, dev)
    assert torch.equal(pth["w1"], value_net.load_checkpoint(CKPT, "cpu")["w1"])
    rc, out = _run_evaluate(["--opponent", "greedy", "--games", "4", "--max-steps", "6",
                             "--checkpoint", str(path)], capsys)
    assert rc == 0 and out["games"] == 4
    orbax = tmp_path / "orbax" / "12"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for bad in (str(tmp_path / "orbax"), str(orbax)):
        with pytest.raises(SystemExit) as e:
            evaluate.main(["--device", "cpu", "--checkpoint", bad])
        assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        evaluate.main(["--device", "cpu", "--opponent", str(tmp_path / "orbax")])
    assert e.value.code == 2
