"""The port's rules-parity and quality tools on the card against the port's
CPU path: one batch of the rules stress in both configurations, the 2-ply
decision guard's scores, and the learning-curve sweep's two graphs.

These tests need a CUDA card and skip elsewhere (the nd_tail kernel and the
graphed matches have no CPU mode). The file imports torch and the port
only, so on the card it runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tools_gpu.py
"""
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.eval import arena
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases
from mlp_ppo_2ply_multi_tpu_torch.scripts import eval_curve
from mlp_ppo_2ply_multi_tpu_torch.scripts import stress_movegen2 as stress
from mlp_ppo_2ply_multi_tpu_torch.scripts import twoply_decision_guard as guard
from tests.test_torch_kernel_gpu import _card

RTOL, ATOL = 1e-5, 1e-6


def _batch(seed, n, bias, dev):
    boards, players, dice = sample_cases(seed, n, doubles_bias=bias)
    data = np.array([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
                    dtype=np.int8)
    return (torch.from_numpy(data).to(dev), torch.tensor(players, dtype=torch.int32, device=dev),
            torch.tensor(dice, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["a", "b"])
def test_stress_batch_card_equals_cpu(name):
    """Batch 0 of the stress: every row's afterstates (in slot order) and
    overflow flags equal on the card and the CPU; (a) launches nd_tail."""
    dev = _card()
    cfg, bias, split = stress.configs()[name]
    before = nd_tail.KERNEL.launches
    rows_c, over_c = stress.engine_rows(cfg, split, *_batch(stress.SEED0, stress.BATCH, bias, dev))
    launched = nd_tail.KERNEL.launches - before
    rows_h, over_h = stress.engine_rows(cfg, split, *_batch(stress.SEED0, stress.BATCH, bias,
                                                            torch.device("cpu")))
    np.testing.assert_array_equal(over_c, over_h)
    for g in range(stress.BATCH):
        np.testing.assert_array_equal(rows_c(g), rows_h(g), err_msg=f"row {g}")
    assert launched == (1 if name == "a" else 0)
    rep = stress.run(name, 1, dev)
    assert rep["mismatches"] == 0 and rep["positions"] == stress.BATCH


@pytest.mark.gpu
def test_guard_scores_card_equal_cpu():
    """Both scorers on 24 sampled positions: the top-K slots equal, the
    scores within rtol 1e-5, atol 1e-6 (TF32 off), on the card and the CPU."""
    dev = _card()
    boards, players, dice = _batch(7, 24, 0.2, torch.device("cpu"))
    params = value_net.load_checkpoint(str(guard.CKPT), dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    for cfg in guard.configs():
        topi_c, sc_c = guard.score(params, boards.numpy(), players.numpy(), dice.numpy(), cfg, dev)
        topi_h, sc_h = guard.score(cpu_params, boards.numpy(), players.numpy(), dice.numpy(), cfg,
                                   "cpu")
        np.testing.assert_array_equal(topi_c, topi_h)
        np.testing.assert_allclose(sc_c, sc_h, rtol=RTOL, atol=ATOL)
        assert (sc_h > -1e8).any()


@pytest.mark.gpu
def test_curve_sweep_captures_two_graphs(tmp_path):
    """Three checkpoints swept at 16 games: 2 graphs captured, and each
    checkpoint's winners equal a separate play_match on its own params."""
    dev = _card()
    cfg = Config()
    for i, eps in enumerate((0, 8, 16)):
        gen = torch.Generator().manual_seed(i)
        value_net.save_checkpoint(value_net.init_params(cfg.model, gen, "cpu"),
                                  str(tmp_path / f"ep{eps:08d}.pth"))
    graphs.clear_graphs()
    curves, info = eval_curve.sweep([str(tmp_path)], games=16, max_steps=32, device=dev)
    assert info["captures"] == 2 and info["checkpoints"] == 3
    greedy, rand = arena.greedy_policy(cfg), arena.random_policy(cfg)
    for i, (eps, path, _) in enumerate(eval_curve.checkpoints(str(tmp_path))):
        p = value_net.load_checkpoint(path, dev)
        seed = eval_curve.SEED_STRIDE * (i + 1)
        for side, (a, b) in enumerate(((greedy, rand), (rand, greedy))):
            res = arena.play_match(p, p, a, b, torch.Generator(device=dev).manual_seed(seed + side),
                                   cfg, 8, 32, device=dev)
            assert torch.equal(res.winner.cpu(), info["winners"][str(tmp_path)][i][side])
    assert [r["episodes"] for r in curves[str(tmp_path)]] == [0, 8, 16]
    graphs.clear_graphs()
