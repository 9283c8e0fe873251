"""The non-doubles front kernel's host side on the CPU (``ops.nd_front``) and
the front's route (``movegen2.nd_front``).

* ``nd_front`` on CPU tensors, shaped batches and broadcast operands come
  back in the board's batch shape, equal to ``_nd_candidates`` on the
  flattened operands.
* A CPU tensor takes the plain chain: the kernel is neither planned nor
  launched, nothing is counted as ``nd_front_plain``; ``enumerate_nondoubles``
  without passes and ``legal_moves_split`` take their front from
  ``nd_front``, the 2-ply replies (passes handed in) from ``_nd_candidates``,
  on sampled and built positions (bar entries against blocked points,
  bear-offs through the farthest and the exact slot, no legal move, a
  forced single move that zeroes pass B) of both players.
* The rollout steps hand the front the players and dice the kernel takes
  (it reads a die outside 1..6 as the nearest face, unchecked).
* The launch planner and the shared memory of a block, by hand.
* ``bound``: the bytes in and out.
* The kernel wrapper refuses a CPU board, a wrong dtype and a wrong shape.

The kernel itself on the card: tests/test_torch_nd_front_gpu.py. Its
counters in the tracer: tests/test_torch_kernel_seam.py.
"""
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.ops import nd_front
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P
from tests.test_torch_trace import config as trace_config

H100_SMS = 132


def _board(p0=(), p1=(), bar=(0, 0), off=(0, 0)):
    c = np.zeros(52, np.int8)
    for i, k in p0:
        c[i] = k
    for i, k in p1:
        c[24 + i] = k
    c[48:50], c[50:52] = bar, off
    return c


def _mirror(c):
    """The same position with the players' roles swapped (player 1 to move)."""
    m = np.zeros(52, np.int8)
    m[0:24], m[24:48] = c[24:48][::-1], c[0:24][::-1]
    m[48], m[49], m[50], m[51] = c[49], c[48], c[51], c[50]
    return m


def edge_cases():
    """(cells, player, dice): player 0's built positions and their mirrors."""
    out = []
    for cells, dice in (
        # bar entries: both entry points blocked, one blocked, a hit on entry
        (_board(p0=[(10, 13)], p1=[(2, 2), (4, 2), (20, 11)], bar=(2, 0)), (3, 5)),
        (_board(p0=[(10, 14)], p1=[(2, 2), (20, 13)], bar=(1, 0)), (3, 5)),
        (_board(p0=[(10, 13)], p1=[(4, 1), (20, 14)], bar=(2, 0)), (5, 2)),
        # bear-offs: through the farthest slot, the exact slot, to a win
        (_board(p0=[(20, 4), (22, 6), (23, 5)], p1=[(0, 15)]), (6, 5)),
        (_board(p0=[(18, 3), (20, 4), (23, 8)], p1=[(0, 15)]), (4, 1)),
        (_board(p0=[(22, 1), (23, 1)], p1=[(0, 15)], off=(13, 0)), (2, 1)),
        # no legal move: a prime in front of every checker
        (_board(p0=[(5, 15)], p1=[(i, 2) for i in range(6, 13)] + [(0, 1)]), (2, 1)),
        # a forced single move: 0 -> 6 or 0 -> 5 and no second step, so
        # pass A has one single and zeroes pass B
        (_board(p0=[(0, 1)], p1=[(11, 2), (1, 13)], off=(14, 0)), (6, 5)),
        # a single checker that plays both dice; fifteen blots; doubles rows
        (_board(p0=[(0, 1)], p1=[(20, 15)], off=(14, 0)), (4, 3)),
        (_board(p0=[(i, 1) for i in range(15)], p1=[(20, 15)]), (6, 2)),
        (_board(p0=[(0, 2), (11, 5), (16, 3), (18, 5)], p1=[(23, 2), (12, 5), (7, 3), (5, 5)]),
         (4, 4)),
    ):
        out += [(cells, 0, dice), (_mirror(cells), 1, dice)]
    return out


def tensors(cases, dev="cpu"):
    """Board, player [n] and dice [n, 2] of (cells, player, dice) cases."""
    cells = torch.tensor(np.stack([c for c, _, _ in cases]), device=dev)
    player = torch.tensor([p for _, p, _ in cases], device=dev)
    dice = torch.tensor([list(d) for _, _, d in cases], device=dev)
    return Board(cells), player, dice


def sampled(n, seed, dev="cpu"):
    boards, players, dice = sample_cases(seed, n, doubles_bias=0.1)
    cells = [np.array(b[0] + b[1] + b[2] + b[3], np.int8) for b in boards]
    return tensors(list(zip(cells, players, dice)), dev)


def _want(board, player, dice):
    pa, pb, valid, d_hi, d_lo = movegen2._nd_candidates(board, player, dice)
    return pa.b1.data, pb.b1.data, valid, d_hi, d_lo


def _assert_front(got, want, what):
    b1a, b1b, valid, d_hi, d_lo = got
    for name, a, b in zip(("b1a", "b1b", "valid", "d_hi", "d_lo"),
                          (b1a.data, b1b.data, valid, d_hi, d_lo), want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name, a.shape, b.shape)
        assert torch.equal(a, b), (what, name)


def test_the_edge_cases_reach_what_they_are_built_for():
    """The built positions hold the rows the card's tests compare: no legal
    move, a pass B zeroed by the skip, bear-offs through slots 25 and 26, a
    bar entry, for both players."""
    board, player, dice = tensors(edge_cases())
    pa, pb, valid, _, _ = movegen2._nd_candidates(board, player, dice)
    assert bool((valid.sum(-1) == 0).any())
    skip = ~pa.any_pair & (pa.single_valid.sum(-1) == 1)
    assert bool((skip & pb.single_valid.any(-1)).any())  # the skip drops a pass-B single
    assert bool(pa.s1.valid[:, 25].any()) and bool(pa.s1.valid[:, 26].any())
    assert bool(pa.s1.valid[:, 24].any())
    assert set(player.tolist()) == {0, 1}


def test_shaped_batches_and_broadcast_operands():
    """Any batch shape: the front flattens, and its outputs come back in the
    board's batch shape, equal to the plain chain on the same operands."""
    board, player, dice = sampled(24, 5)
    shaped = Board(board.data.reshape(2, 12, 52))
    for p, d in ((player.reshape(2, 12), dice.reshape(2, 12, 2)),
                 (torch.tensor(1), torch.tensor([5, 2])),
                 (player.reshape(2, 12).to(torch.int32), dice.reshape(2, 12, 2).to(torch.int32))):
        got = movegen2.nd_front(shaped, p, d)
        pp = torch.broadcast_to(p.long(), (2, 12))
        dd = torch.broadcast_to(d.long(), (2, 12, 2))
        _assert_front(got, _want(shaped, pp, dd), f"player {tuple(p.shape)}")
        assert got[0].data.shape == (2, 12, 27, 52) and got[3].shape == (2, 12)


@pytest.mark.parametrize("source", ["sampled", "edges"])
def test_the_enumerations_take_their_front_from_nd_front(source, monkeypatch):
    """``enumerate_nondoubles`` without passes, ``legal_moves`` and
    ``legal_moves_split`` call ``nd_front``, which on CPU tensors takes the
    plain chain: the kernel is neither planned nor launched, and nothing is
    counted as ``nd_front_plain`` (counted on a card only);
    ``enumerate_nondoubles`` with passes (the 2-ply replies) keeps
    ``_nd_candidates``."""
    board, player, dice = sampled(64, 23) if source == "sampled" else tensors(edge_cases())
    n = board.data.shape[0]

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel route ran on the CPU")

    monkeypatch.setattr(nd_front, "launch_kernel", no_kernel)
    monkeypatch.setattr(nd_front, "plan", no_kernel)
    monkeypatch.setenv(P.TRACE_ENV, "1")
    P.TRACER.reset()
    launches = nd_front.KERNEL.launches
    calls = []
    real = movegen2.nd_front_plain

    def spy(*args):
        calls.append(args[0].data.shape[0])
        return real(*args)

    monkeypatch.setattr(movegen2, "nd_front_plain", spy)
    fast = MoveGenConfig.fast()
    movegen2.legal_moves_split(board, player, dice, fast)
    movegen2.enumerate_nondoubles(board, player, dice, fast)
    movegen2.legal_moves(board, player, dice, MoveGenConfig())
    assert calls == [n, n, n]
    d_hi = torch.maximum(dice[:, 0], dice[:, 1])
    d_lo = torch.minimum(dice[:, 0], dice[:, 1])
    passes = (movegen2._run_pass(board, player, d_hi, d_lo),
              movegen2._run_pass(board, player, d_lo, d_hi))
    movegen2.enumerate_nondoubles(board, player, dice, fast, passes)
    assert calls == [n, n, n]
    got = movegen2.nd_front(board, player, dice)
    assert got[0].data.shape == (n, 27, 52) and got[2].shape == (n, 1512)
    assert nd_front.KERNEL.launches == launches
    assert "nd_front_plain" not in P.TRACER.counters
    P.TRACER.reset()


@pytest.mark.parametrize("path", ["split", "twoply"])
def test_the_main_path_hands_the_front_dice_it_takes(path, monkeypatch):
    """The kernel reads a die outside 1..6 as the nearest face, unchecked
    (a check would read the card): every ``nd_front`` call of the rollout
    steps, 1-ply and the 2-ply step's own moves, gets players 0 and 1 and
    dice 1..6, the rolls of the env and of its openings."""
    seen = []
    real = movegen2.nd_front

    def spy(board, player, dice):
        n = board.data.shape[0]
        seen.append((torch.broadcast_to(torch.as_tensor(player), (n,)).clone(),
                     torch.broadcast_to(torch.as_tensor(dice), (n, 2)).clone()))
        return real(board, player, dice)

    monkeypatch.setattr(movegen2, "nd_front", spy)
    cfg = trace_config(path)
    gen = torch.Generator().manual_seed(9)
    state = vec_env.reset(16, gen, "cpu")
    params = td.init_train_state(cfg, gen, "cpu").params
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rollout.rollout_loop(params, state, 1.0, cfg, 12, True, gen=gen, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(seen) == 12
    players = torch.cat([p for p, _ in seen])
    dice = torch.cat([d for _, d in seen])
    assert set(players.tolist()) == {0, 1}
    assert int(dice.min()) == 1 and int(dice.max()) == 6


@pytest.mark.parametrize("n, games, blocks", [
    (4096, 8, 512),  # the 1-ply step: 31 games an SM, eight a block
    (1024, 4, 256),  # the 2-ply step's own moves: 7 an SM, four a block
    (600, 4, 150),
    (300, 2, 150),
    (256, 1, 256),  # under two games an SM: a warp a block
    (33, 1, 33),
    (1, 1, 1),
    (0, 1, 0),
    (1_000_000, 8, 125_000),  # at most eight a block
])
def test_plan_by_game_count(n, games, blocks):
    p = nd_front.plan(n, H100_SMS)
    assert (p["games"], p["blocks"], p["threads"]) == (games, blocks, 32 * games)
    assert p["smem_bytes"] == nd_front.smem_bytes(games) <= 48 * 1024
    assert p["blocks"] * games >= n


@pytest.mark.parametrize("games, want", [
    # 2 x up16(games x 1404) + up16(games x 1512) + games x (64 + 56 x 4)
    (1, 2 * 1408 + 1520 + 288),
    (2, 2 * 2816 + 3024 + 2 * 288),
    (3, 2 * 4224 + 4544 + 3 * 288),
    (4, 2 * 5616 + 6048 + 4 * 288),
    (8, 2 * 11232 + 12096 + 8 * 288),
])
def test_shared_memory_of_a_block(games, want):
    got = nd_front.smem_bytes(games)
    assert got == want and got % 16 == 0
    assert games * (2 * 1404 + 1512) <= got


@pytest.mark.parametrize("games", [0, 9, -1])
def test_the_planner_refuses_other_block_sizes(games):
    with pytest.raises(ValueError):
        nd_front.smem_bytes(games)


def test_bound_counts_the_bytes_in_and_out():
    b = nd_front.bound(4096)
    assert b["bytes"] == 4096 * (52 + 8 + 2 * 8) + 4096 * (2 * 27 * 52 + 1512 + 2 * 8)
    assert b["bytes"] == 18_071_552  # about 4.4 KB a game
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    assert nd_front.bound(0)["bytes"] == 0


@pytest.mark.parametrize("what", ["cpu", "int16", "width", "rank"])
def test_the_kernel_wrapper_refuses_a_board_it_does_not_take(what):
    board, player, dice = sampled(4, 3)
    b = {"cpu": board.data, "int16": board.data.to(torch.int16), "width": board.data[:, :51],
         "rank": board.data[None]}[what]
    with pytest.raises(ValueError, match="cuda" if what == "cpu" else "int8"):
        nd_front.launch_kernel(b, player, dice)


@pytest.mark.parametrize("name, x, shape", [
    ("dice", torch.ones((4, 2)), (4, 2)),  # floats
    ("dice", torch.ones((4, 3), dtype=torch.int64), (4, 2)),  # not [n, 2]
    ("player", torch.ones(4, dtype=torch.bool), (4,)),
    ("player", torch.zeros(5, dtype=torch.int64), (4,)),
])
def test_the_kernel_wrapper_refuses_operands_it_does_not_take(name, x, shape):
    """The player and dice checks ``launch_kernel`` makes after the board's
    (on the CPU here: they read no device)."""
    with pytest.raises(ValueError, match=name):
        nd_front._ints(name, x, shape, torch.device("cpu"))


def test_the_kernel_wrapper_takes_broadcast_integer_operands():
    t = nd_front._ints("player", torch.tensor(1, dtype=torch.int8), (4,), torch.device("cpu"))
    assert t.dtype == torch.int64 and t.shape == (4,) and t.stride() == (0,)
    d = nd_front._ints("dice", [6, 1], (4, 2), torch.device("cpu"))
    assert d.tolist() == [[6, 1]] * 4
