"""wildbg's deep value net on the port (``ModelConfig.wildbg``) against the
plain reference ``oracle/wildbg_net.py``, on the CPU at small sizes with
seeded random weights: the forward in f32 and in bf16, the fused board
route (``ops.mlp_value.mlp_value_plain``), one learner update, 2-ply
scores, the .pth layout, the rows the 2-ply step hands the net, and the
paths that refuse the net.

Tolerances. f32 against f32: the same products in another summation order,
1e-6 relative. The bf16 routes round both operands of each product to bf16
(relative error <= 2^-9 each), so a layer's pre-activations move by up to
2 x 2^-9 of their scale, and four layers by up to 8 x 2^-9: BF16_TOL, of the
spread of the net's values (measured: 0.36-0.48%). An fp8 forward (e4m3,
2^-4 an operand) lies beyond it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import (Config, EnvConfig, ModelConfig,
                                                      TrainConfig, TwoPlyConfig)
from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as V
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from mlp_ppo_2ply_multi_tpu_torch.ops import mlp_value as M
from mlp_ppo_2ply_multi_tpu_torch.oracle import wildbg_net as ref
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases
from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax

BF16_TOL = 8 * 2.0**-9  # of the values' spread (module docstring)
CFG = ModelConfig.wildbg()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(seed=3, scale=1.0):
    p = V.init_params(CFG, torch.Generator().manual_seed(seed), "cpu")
    return {k: v * scale for k, v in p.items()}


def _ref_sd(params):
    return ref.from_wildbg_state_dict(V.to_state_dict(params))


def _positions(seed, n):
    boards, players, dice = sample_cases(seed, n)
    data = torch.tensor(np.array([[x for part in b for x in part] for b in boards], np.int8))
    return Board(data), torch.tensor(players, dtype=torch.int32), torch.tensor(dice).int()


def _feats(seed=0, n=400):
    board, player, _ = _positions(seed, n)
    return encode_board(board, player)


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------


def test_config_describes_the_net_and_refuses_what_it_cannot_value():
    assert V.layer_sizes(CFG) == (198, 300, 250, 200, 6)
    p = _params()
    assert sum(t.numel() for t in p.values()) == 186_356
    assert V.depth(p) == 4 and V.is_deep(p) and not V.is_deep(V.init_params(ModelConfig(), None, "cpu"))
    assert Config.production() == Config.production().replace()  # defaults untouched
    assert not Config.production().model.deep and not Config.production_twoply().model.deep
    with pytest.raises(ValueError, match="ReLU"):
        ModelConfig(hidden_sizes=(300, 250, 200))
    with pytest.raises(ValueError, match="activation"):
        ModelConfig(activation="tanh")
    with pytest.raises(ValueError, match="win rewards"):
        Config(model=CFG, env=EnvConfig(reward_win_backgammon=3.0))


def test_init_is_linear_default_uniform():
    p = _params(seed=11)
    for i, (a, b) in enumerate(zip((198, 300, 250, 200), (300, 250, 200, 6)), 1):
        bound = 1.0 / np.sqrt(a)
        assert 0.99 * bound < float(p[f"w{i}"].abs().max()) <= bound
        assert float(p[f"b{i}"].abs().max()) <= bound
    q = _params(seed=11)
    assert all(torch.equal(p[k], q[k]) for k in p)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_forward_f32_equals_the_reference(scale):
    p = _params(scale=scale)
    x = _feats()
    got = V.forward(p, x, CFG)
    want = ref.value(_ref_sd(p), x)
    assert got.shape == (400,) and got.dtype == torch.float32
    assert float(want.abs().max()) <= 2.5
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    logits = ref.logits(_ref_sd(p), x)
    torch.testing.assert_close(ref.equity(logits), want)


def _fp8(t):
    s = t.abs().max().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _low_precision_forward(p, x, kind):
    """The net with every product's operands rounded to fp8, or in TF32
    (the operands' mantissas cut to 10 bits)."""
    cut = _fp8 if kind == "fp8" else (lambda t: (t.view(torch.int32) & ~0x1FFF).view(torch.float32))
    h = x
    for i in range(1, 5):
        h = cut(h) @ cut(p[f"w{i}"]) + p[f"b{i}"]
        if i < 4:
            h = torch.relu(h)
    return torch.softmax(h, -1) @ torch.tensor(ref.U)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_bf16_forward_within_bf16_rounding_and_lower_precisions_beyond(scale):
    p = _params(scale=scale)
    x = _feats(1)
    want = ref.value(_ref_sd(p), x)
    tol = BF16_TOL * float(want.max() - want.min())
    got = V.forward(p, x, dataclasses.replace(CFG, dtype="bfloat16"))
    assert float((got - want).abs().max()) <= tol
    assert float((_low_precision_forward(p, x, "fp8") - want).abs().max()) > tol
    # the board route: B1's telescoped layer 1 at width 300, bf16 rounding points
    board, player, _ = _positions(2, 400)
    b_want = ref.value(_ref_sd(p), encode_board(board, player))
    b_tol = BF16_TOL * float(b_want.max() - b_want.min())
    b_got = M.mlp_value_plain(board.data, player, p)
    assert float((b_got - b_want).abs().max()) <= b_tol
    assert float((fv.fused_value(board.data, player, p) - b_got).abs().max()) == 0


def test_tf32_forward_is_beyond_f32():
    p = _params(scale=3.0)
    x = _feats(4)
    want = ref.value(_ref_sd(p), x)
    low = _low_precision_forward(p, x, "tf32")
    err = float((low - want).abs().max())
    assert err > 1e-6 * float(want.abs().max()) * 100  # a TF32 forward fails the f32 check


def test_plain_board_route_masks_and_counts():
    p = _params()
    board, player, _ = _positions(5, 60)
    data = board.data.reshape(6, 10, 52)
    flag = player.reshape(6, 10)
    valid = torch.from_numpy(np.random.default_rng(0).random((6, 10)) < 0.4)
    c0 = M.counters("cpu").clone()
    got = fv.fused_value(data, flag, p, valid)
    d = M.counters("cpu") - c0
    assert int(d[0]) == int(valid.sum()) and int(d[1]) == 60
    full = M.mlp_value_plain(data, flag, p)
    assert torch.equal(got[valid], full[valid]) and bool((got[~valid] == 0).all())


def test_forward_np_and_pth_round_trip_in_wildbgs_layout(tmp_path):
    p = _params(7)
    path = str(tmp_path / "w.pth")
    V.save_checkpoint(p, path)
    sd = torch.load(path, weights_only=True)
    assert sorted(sd) == sorted(f"{m}.{s}" for m in ref.LAYERS for s in ("weight", "bias"))
    assert tuple(sd["hidden1.weight"].shape) == (300, 198)
    assert tuple(sd["output.weight"].shape) == (6, 200)
    q = V.load_checkpoint(path, "cpu")
    assert list(q) == list(p) and all(torch.equal(p[k], q[k]) for k in p)
    x = _feats(3, 50)
    np.testing.assert_allclose(V.forward_np({k: v.numpy() for k, v in q.items()}, x.numpy()),
                               ref.value(ref.from_wildbg_state_dict(sd), x).numpy(),
                               rtol=1e-5, atol=1e-6)
    bad = dict(sd)
    bad.pop("output.bias")
    with pytest.raises(ValueError, match="layout"):
        V.from_state_dict(bad, "cpu")


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------


def _traj(seed, T=12, B=16):
    from mlp_ppo_2ply_multi_tpu_torch.actor.rollout import Transition

    rng = np.random.default_rng(seed)
    board, _, _ = _positions(seed, T * B)
    rec = rng.random((T, B)) < 0.8
    boundary = rng.random((T, B)) < 0.1
    done = boundary & rec & (rng.random((T, B)) < 0.7)
    win_type = np.where(done, rng.integers(1, 4, (T, B)), 0).astype(np.int8)
    reward = np.where(done, np.array([0.0, 1.0, 2.0, 2.5])[win_type], 0.0).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))
    return Transition(
        packed_board=board.data.reshape(T, B, 52), player=t(rng.integers(0, 2, (T, B)).astype(np.int32)),
        reward=t(reward), recorded=t(rec), done=t(done), boundary=t(boundary),
        value=torch.zeros((T, B)), win_type=t(win_type), close_out=t(np.zeros((T, B), bool)),
        prime=t(np.zeros((T, B), bool)), num_moves=t(np.ones((T, B), np.int32)),
        overflow=t(np.zeros((T, B), bool)))


def test_one_learner_update_against_the_references_adam():
    cfg = Config(model=CFG, train=TrainConfig(td_mode="side0", per_episode_updates=False,
                                              grad_clip=1e-3))
    traj = _traj(8)
    p0 = _params(9, scale=2.0)
    state = td.TrainState({k: v.clone() for k, v in p0.items()}, td.init_adam(p0),
                          torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.int64))
    new, metrics = td.update(state, traj, cfg, "cpu")
    # the reference: its TD(0) loss and gradient by autograd, then optax's clip and Adam
    plan = td._plan(traj.reward, traj.recorded, traj.boundary, 0.99, "side0", traj.player)
    sd = _ref_sd(p0)
    feats = encode_board(Board(traj.packed_board), traj.player)
    loss, g_ref = ref.td_loss(sd, feats, plan.reward, plan.nxt, plan.has, traj.recorded, 0.99)
    torch.testing.assert_close(metrics["loss"], loss, rtol=1e-5, atol=0)
    # the reference's gradients in the port's layout and names
    g = {}
    for i, m in enumerate(ref.LAYERS, 1):
        g[f"w{i}"], g[f"b{i}"] = g_ref[f"{m}.weight"].T, g_ref[f"{m}.bias"]
    norm = torch.sqrt(sum((g[k] ** 2).sum() for k in sorted(g)))
    assert float(norm) > 1e-3  # the clip acts
    clipped = {k: v / norm * 1e-3 for k, v in g.items()}
    torch.testing.assert_close(metrics["grad_norm"], norm, rtol=1e-5, atol=0)
    for k in p0:
        mu = 0.1 * clipped[k]
        nu = 0.001 * clipped[k] ** 2
        step = -1e-3 * (mu / 0.1) / (torch.sqrt(nu / 0.001) + 1e-8)
        torch.testing.assert_close(new.opt_state.mu[k], mu, rtol=1e-4, atol=1e-9)
        torch.testing.assert_close(new.params[k] - p0[k], step, rtol=1e-3, atol=1e-7)
    assert sorted(new.opt_state.mu) == sorted(p0) and len(p0) == 8


# ---------------------------------------------------------------------------
# 2-ply
# ---------------------------------------------------------------------------


def _twoply_cfg(fused):
    """The exact scorer, its reply widths wide enough that no reply of
    these positions is cut (the reference's replies are uncut)."""
    return Config(model=dataclasses.replace(CFG, fused_actor_kernel=fused),
                  train=TrainConfig(td_mode="side0", per_episode_updates=False),
                  twoply=TwoPlyConfig(enabled=True, reply_a_max=512))


def _reference_response(sd, cells, opp, cap=50):
    """sum over the 21 rolls of P(roll) x mean of the opponent's top-5 reply
    values (oriented for ``opp``), by the replies of the benchmark's frozen
    rules and the plain net."""
    from benchmark.reference import jobs

    (per_roll, _), = jobs.run_jobs("replies", [(tuple(int(x) for x in cells), opp, cap)])
    total = 0.0
    for r, prob in zip(per_roll, expectimax.PROBS):
        if len(r):
            v = ref.value(sd, encode_board(Board(torch.from_numpy(r)), torch.tensor(1 - opp)))
            o = v if opp == 0 else -v
            total += float(prob) * float(torch.sort(o, descending=True).values[:5].mean())
    return total


def test_twoply_scores_of_a_few_dozen_positions():
    p = _params(13, scale=2.0)
    sd = _ref_sd(p)
    board, player, dice = _positions(17, 12)
    cfg = _twoply_cfg(False)
    ms = movegen2.legal_moves(board, player, dice, cfg.movegen)
    k = 3
    cand = Board(ms.boards.data[:, :k])
    ok = ms.valid[:, :k]
    w_o = expectimax.weighted_opponent_response(p, cand, 1 - player, cfg)
    w_fused = expectimax.weighted_opponent_response(p, cand, 1 - player, _twoply_cfg(True))
    checked = 0
    for b in range(12):
        for c in range(k):
            if not bool(ok[b, c]):
                continue
            want = _reference_response(sd, ms.boards.data[b, c].numpy(), 1 - int(player[b]))
            assert abs(float(w_o[b, c]) - want) <= 1e-5 * max(1.0, abs(want)), (b, c)
            assert abs(float(w_fused[b, c]) - want) <= 0.01, (b, c)
            checked += 1
    assert checked >= 24


def test_rows_needed_are_the_legal_moves_and_the_reranked_candidates_replies():
    """One CPU 2-ply step with the fused route: D2's counter grows by the
    legal afterstates of every game plus, for each game with at least k
    moves, the replies of its top-k candidates over the 21 rolls (the small
    doubles cut to 50), counted by the reference's rules."""
    from benchmark.reference import jobs

    p = _params(21)
    cfg = _twoply_cfg(True)
    board, player, dice = _positions(23, 10)
    ms = movegen2.legal_moves(board, player, dice, cfg.movegen)
    k = cfg.twoply.top_k_candidates
    g = torch.zeros((10, k))
    c0 = M.counters("cpu").clone()
    s = expectimax.sampled_logits_2ply(p, _State(board, player), ms, g,
                                       torch.zeros(ms.valid.shape), torch.tensor(1.0), cfg)
    need = int((M.counters("cpu") - c0)[0])
    want = int(ms.count.sum())
    for b in range(10):
        if int(ms.count[b]) < k:
            continue
        for c in s.cand[b].tolist():
            (per_roll, _), = jobs.run_jobs("replies", [(tuple(int(x) for x in ms.boards.data[b, c]),
                                                        1 - int(player[b]), 50)])
            want += sum(len(r) for r in per_roll)
    assert bool((~ms.overflow).all())
    assert need == want


class _State:
    def __init__(self, board, player):
        self.board, self.player = board, player


# ---------------------------------------------------------------------------
# paths that do not take the net
# ---------------------------------------------------------------------------


def test_paths_without_the_net_refuse_it():
    from mlp_ppo_2ply_multi_tpu_torch.apps import train
    from mlp_ppo_2ply_multi_tpu_torch.parallel import sharding

    p = _params()
    with pytest.raises(ValueError, match="tensor-parallel"):
        sharding.param_specs(True, tuple(p))
    assert sharding.param_specs(False, tuple(p)) == {k: None for k in p}
    with pytest.raises(ValueError, match="tensor-parallel"):
        V.forward(p, _feats(0, 4), dataclasses.replace(CFG, model_axis="model"))
    with pytest.raises(ValueError, match="tensor parallelism"):
        sharding.make_train_step(None, Config(model=CFG), 4, tp=True)
    args = train._parser().parse_args(["--net", "wildbg", "--model", "2", "--data", "1"])
    assert "wildbg" in train._refused(args, train.build_config(args), 2)
    small = dict(p, w4=p["w4"][:, :5], b4=p["b4"][:5])
    with pytest.raises(ValueError, match="built for"):
        M.mlp_value_plain(torch.zeros((2, 52), dtype=torch.int8), 0, small)


def test_train_cli_chooses_the_net():
    from mlp_ppo_2ply_multi_tpu_torch.apps import train

    base = train.build_config(train._parser().parse_args(["--production", "--two-ply"]))
    deep = train.build_config(train._parser().parse_args(["--production", "--two-ply",
                                                          "--net", "wildbg"]))
    assert base == Config.production_twoply().replace(train=base.train)
    assert deep.model == dataclasses.replace(base.model, hidden_sizes=(300, 250, 200),
                                             activation="relu")
    assert deep.replace(model=base.model) == base


# ---------------------------------------------------------------------------
# the tracer's counters of D2
# ---------------------------------------------------------------------------


def test_tracer_counts_d2_rows_by_update(monkeypatch):
    """``mlp_rows_needed`` and ``mlp_rows_computed`` (the growth of D2's
    device counters, which its registry entry hands the tracer) land in
    the record of the update they fell in, read when the update's copy has
    landed: each update's record holds its own rows, the next update's
    calls none of them. (D2's launches by update:
    tests/test_torch_kernel_seam.py.)"""
    from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P

    monkeypatch.setenv(P.TRACE_ENV, "1")
    assert M.KERNEL.device_counters == (("mlp_rows_needed", "mlp_rows_computed"),
                                        M.counter_tensors)
    p = _params()
    board, player, _ = _positions(31, 40)
    data, flag = board.data.reshape(4, 10, 52), player.reshape(4, 10)
    valid = torch.from_numpy(np.random.default_rng(1).random((4, 10)) < 0.5)
    M.counters("cpu")
    P.TRACER.reset()
    want = []
    for update in range(3):
        P.new_update()
        with P.scope("rollout", span=True):
            for _ in range(update + 1):
                fv.fused_value(data, flag, p, valid)
        want.append(((update + 1) * int(valid.sum()), (update + 1) * 40))
        if update == 1:
            # the first update was read as soon as the second opened
            assert [r["counters"].get("mlp_rows_needed") for r in P.trace_records()] == [want[0][0]]
    P.trace_flush()
    recs = P.trace_records()
    got = [tuple(r["counters"].get(k) for k in ("mlp_rows_needed", "mlp_rows_computed"))
           for r in recs]
    assert got == want
    s = P.trace_summary()
    assert (s["trace/mlp_rows_needed"], s["trace/mlp_rows_computed"]) == (
        3.0 * int(valid.sum()), 120.0)
    # calls outside any update go to the next record; a reset forgets them
    fv.fused_value(data, flag, p)
    P.TRACER.reset()
    P.new_update()
    with P.scope("rollout", span=True):
        fv.fused_value(data, flag, p, valid)
    P.trace_flush()
    (rec,) = P.trace_records()
    assert rec["counters"]["mlp_rows_needed"] == int(valid.sum())
    # tracing off: the counters go on, the tracer keeps nothing
    monkeypatch.setenv(P.TRACE_ENV, "0")
    P.TRACER.reset()
    fv.fused_value(data, flag, p, valid)
    assert P.trace_records() == []
    P.TRACER.reset()


def test_tesauros_net_leaves_d2s_counters_alone(monkeypatch):
    from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P

    monkeypatch.setenv(P.TRACE_ENV, "1")
    P.TRACER.reset()
    p = V.init_params(ModelConfig(), torch.Generator().manual_seed(1), "cpu")
    board, player, _ = _positions(33, 8)
    before = {k: v.clone() for k, v in M.counter_tensors().items()}
    launches = M.KERNEL.launches
    P.new_update()
    with P.scope("rollout", span=True):
        fv.fused_value(board.data, player, p, torch.ones(8, dtype=torch.bool))
    P.trace_flush()
    (rec,) = P.trace_records()
    assert rec["counters"] == {"dd_kernel_launches": 0, "nd_tail_kernel_launches": 0,
                               "mlp_kernel_launches": 0}
    assert M.KERNEL.launches == launches
    assert all(torch.equal(before[k], v) for k, v in M.counter_tensors().items() if k in before)
    P.TRACER.reset()
