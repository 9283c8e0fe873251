"""The redesigned row-take kernel and the sorted move generator on the card.

These tests need a CUDA card and skip elsewhere (a CUDA kernel has no CPU
mode). The file imports torch and the port only, so on the card it runs
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_sorted_gpu.py

* ``take_rows`` bit-equal to ``take_rows_plain`` at the sorted engine's
  shapes and the earlier ones, through both branches of the kernel (a
  game's table staged in shared memory, its used rows gathered): W not a
  multiple of 4 (the 4-byte copies), N a multiple of no CTA's games, K * C
  not a multiple of 16 (the 4-byte stores), C other than 52, tables over
  the shared-memory budget and indices outside [0, W).
* The sorted ``legal_moves`` on the card equals the CPU's at B = 64: every
  field, every slot; its takes launch the kernel.
* A merged rollout on the sorted engine, graphed (``rollout_chunked``),
  equals the eager loop, with 8 take_rows launches a step by replay.
"""
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import board as B
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen as M
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import take_rows as tr
from mlp_ppo_2ply_multi_tpu_torch.scripts import trajectory_parity as TP
from tests.test_torch_kernel_gpu import _card

# the sorted engine's takes at its default widths: non-doubles' first ply
# (K = a_max from the 27 first-ply boards), each doubles level's parents,
# and the forced-shorter records in rank order
SORTED_SHAPES = [(27, 512), (16, 128), (128, 288), (288, 512), (16, 16), (128, 128),
                 (288, 288)]


def _inputs(n, w, k, c, dev, dtype=torch.int32, outside=0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    boards = torch.randint(-128, 128, (n, w, c), generator=gen, device=dev, dtype=torch.int8)
    idx = torch.randint(0, max(w, 1), (n, k), generator=gen, device=dev, dtype=dtype)
    if outside:
        flat = idx.view(-1)
        pos = torch.randint(0, flat.numel(), (outside,), generator=gen, device=dev)
        bad = torch.tensor([-1, w, w + 7, -(2**31)], device=dev, dtype=dtype)
        flat[pos] = bad[torch.arange(outside, device=dev) % 4]
    return boards, idx


def _check_take(boards, idx):
    n, w, c = boards.shape
    before = tr.KERNEL.launches
    got = tr.take_rows(boards, idx)
    assert tr.KERNEL.launches == before + 1
    want = tr.take_rows_plain(boards, idx)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (n, idx.shape[1], c)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("w,k", SORTED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_take_rows_at_the_sorted_engine_shapes(w, k, dtype):
    dev = _card()
    boards, idx = _inputs(4096, w, k, 52, dev, dtype)
    assert tr.plan(4096, w, k, 52)["staged"]
    _check_take(boards, idx)


@pytest.mark.gpu
@pytest.mark.parametrize("n,w,k,c,outside,staged", [
    (4096, 128, 128, 52, 0, True),  # the probe's shape
    (4096, 448, 96, 52, 0, False),  # the actor's tier-1 shape: rows gathered
    (4099, 27, 512, 52, 0, True),  # W % 4 != 0, N a multiple of no CTA's games
    (1001, 16, 16, 52, 40, True),  # a few games a CTA, the last CTA short
    (777, 9, 7, 52, 30, True),  # K * C not a multiple of 16: 4-byte stores
    (513, 300, 30, 52, 50, False),  # gathered, 4-byte stores
    (64, 1200, 700, 52, 200, False),  # a table over the shared-memory budget
    (300, 21, 33, 12, 20, True),  # C = 12: the generic word count
    (200, 50, 20, 200, 20, False),  # C = 200
    (100, 64, 64, 8, 0, True),  # C = 8, 16-byte copies and stores
])
def test_take_rows_branches_and_edges(n, w, k, c, outside, staged):
    dev = _card()
    assert tr.plan(n, w, k, c)["staged"] == staged
    for dtype in (torch.int32, torch.int64):
        boards, idx = _inputs(n, w, k, c, dev, dtype, outside, seed=n + w)
        _check_take(boards, idx)
        if outside:
            ok = (idx >= 0) & (idx < w)
            assert not tr.take_rows(boards, idx)[~ok].any()


@pytest.mark.gpu
def test_take_rows_with_no_table_rows_gives_zero_rows():
    dev = _card()
    boards = torch.zeros((5, 0, 52), dtype=torch.int8, device=dev)
    idx = torch.zeros((5, 8), dtype=torch.int32, device=dev)
    _check_take(boards, idx)


@pytest.mark.gpu
def test_sorted_legal_moves_on_the_card_equal_the_cpu():
    """B = 64 states from a few steps of the trajectory games: the card's
    MoveSet equals the CPU's in every field and slot, and each decision
    launches the row take 8 times (2 first-ply, 3 parent, 3 shorts)."""
    dev = _card()
    opener, first, dice, raw = TP.fixed_streams(4096)
    n = 64
    st = vec_env.reset_from_rolls(torch.from_numpy(opener[:n]), torch.from_numpy(first[:n]))
    h = torch.zeros(n, dtype=torch.int64)
    for t in range(6):
        st, h = TP.play_step(st, h, torch.from_numpy(raw[t, :n]), torch.from_numpy(dice[t, :n]))
    cfg = MoveGenConfig(algo="sorted")
    for dice_t in (st.dice, torch.from_numpy(np.repeat(dice[7, :n, :1], 2, 1))):
        want = M.legal_moves(st.board, st.player, dice_t, cfg)
        before = tr.KERNEL.launches
        got = M.legal_moves(B.Board(st.board.data.to(dev)), st.player.to(dev), dice_t.to(dev), cfg)
        torch.cuda.synchronize()
        assert tr.KERNEL.launches == before + 8
        assert got.overflow is None
        for a, b in zip((want.boards.data, want.valid, want.count),
                        (got.boards.data, got.valid, got.count)):
            assert a.dtype == b.dtype and torch.equal(a, b.cpu())


@pytest.mark.gpu
def test_graphed_sorted_rollout_equals_the_eager_loop():
    """``Config()`` (the merged f32 actor) on the sorted engine, 8 steps at
    B = 64: ``rollout_chunked`` (chunk 4, a CUDA graph replayed) against
    ``rollout_loop`` from one state and generator seed; integer fields
    bit-equal, values within an f32 rounding, no overflow, 8 take_rows
    launches a step in both."""
    dev = _card()
    graphs.clear_graphs()
    cfg = Config(movegen=MoveGenConfig(algo="sorted"))
    params = value_net.init_params(cfg.model, torch.Generator(device=dev).manual_seed(3), dev)
    runs, launches = [], []
    for graphed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(5)
        st = vec_env.reset(64, gen, device=dev)
        before = tr.KERNEL.launches
        if graphed:
            runs.append(rollout.rollout_chunked(params, st, 1.0, cfg, 8, chunk=4, gen=gen,
                                                device=dev))
        else:
            runs.append(rollout.rollout_loop(params, st, 1.0, cfg, 8, True, gen=gen, device=dev))
        torch.cuda.synchronize()
        launches.append(tr.KERNEL.launches - before)
    assert launches == [8 * 8, 8 * 8]
    (s0, t0), (s1, t1) = runs
    assert not bool(t1.overflow.any()) and bool(t1.recorded.any())
    for a, b in zip(list(s0) + list(t0), list(s1) + list(t1)):
        a, b = (a.data, b.data) if isinstance(a, B.Board) else (a, b)
        if a.is_floating_point():
            assert float((a - b).abs().max()) <= 1e-5
        else:
            assert torch.equal(a, b)
    graphs.clear_graphs()
