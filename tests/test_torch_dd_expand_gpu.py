"""The doubles enumeration kernel (``ops.dd_expand``) on the card against
the plain chain (``movegen2.enumerate_doubles_plain``): every output tensor
byte for byte, invalid entries included.

* Widths: ``fast()`` (the 1-ply sub-batch), ``Config()``, each die's tuned
  2-ply reply widths, and narrow widths that overflow at w1, at each level
  and at the Q7 cap (the level-4 prefix and a shorts level compacted).
* Positions: self-play positions of the production step, the oracle's
  sampled positions, and built edge cases (a blocked and a half-blocked bar
  entry, checkers on the bar with doubles, a hit on entry, bear-off through
  the farthest lane and through the exact lane, no legal move, forced shorts
  of 1, 2 and 3 submoves, wide levels), each for both players.
* Game counts that are not a multiple of the games a block, 1 included;
  broadcast and non-contiguous operands.
* Inside a captured CUDA graph, replayed on new inputs.
* Under torch.profiler: the kernel's device time attributed to ``dd_L1``.
* A graphed 1-ply chunk of the production step and a graphed 2-ply step, run
  through the kernel and through the plain chain: identical trajectories and
  states; the tracer's record counts one launch a 1-ply step and seven a
  2-ply step, and no plain call.

These tests need a CUDA card and skip elsewhere (the kernel has no CPU
mode). The file imports torch and the port only, so on the card it runs
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_dd_expand_gpu.py
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig, TwoPlyConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import _cuda_build, dd_expand
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P
from tests.test_torch_graph_gpu import _assert_same, _production
from tests.test_torch_kernel_gpu import CKPT, _card

REPLY = {f"reply_die{d}": MoveGenConfig(w1=16, w2=w2, w3=w3, w4=w4, a_max=a_max)
         for d, (w2, w3, w4, a_max) in enumerate(TwoPlyConfig.tuned().dd_reply_widths, start=1)}
WIDTHS = {
    "fast": MoveGenConfig.fast(),
    "full": MoveGenConfig(),
    **REPLY,
    # overflow at w1 and at every level; shorts levels wider than a_max
    "narrow": MoveGenConfig(w1=2, w2=5, w3=7, w4=9, a_max=3),
    "narrow_levels": MoveGenConfig(w1=4, w2=12, w3=30, w4=60, a_max=20),
    # level 4 wider than a_max: the Q7 prefix
    "q7": MoveGenConfig(w1=16, w2=96, w3=224, w4=448, a_max=100),
    "w3_over_w2": MoveGenConfig(w1=3, w2=40, w3=20, w4=200, a_max=30),
}


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
    """(cells, player, die): player 0's built positions and their mirrors."""
    wall = [(i, 2) for i in range(6)]  # player 1 holds every entry point of player 0
    spaced = lambda gap: [(i, 2) for i in range(6) if i != gap]
    out = []
    for cells, die in (
        (_board(p0=[(10, 13)], p1=wall + [(20, 3)], bar=(2, 0)), 3),  # entry blocked: no move
        (_board(p0=[(10, 13)], p1=spaced(2) + [(20, 5)], bar=(2, 0)), 3),  # half-blocked entry
        (_board(p0=[(10, 11)], p1=spaced(3) + [(20, 5)], bar=(4, 0)), 4),  # four on the bar
        (_board(p0=[(12, 12)], p1=[(3, 1), (7, 2), (20, 12)], bar=(3, 0)), 4),  # entry hits
        (_board(p0=[(20, 4), (22, 6), (23, 5)], p1=[(0, 15)]), 6),  # the farthest lane
        (_board(p0=[(18, 3), (20, 4), (23, 8)], p1=[(0, 15)]), 6),  # the exact lane
        (_board(p0=[(18, 1), (21, 2)], p1=[(0, 15)], off=(12, 0)), 2),  # bear off to a win
        (_board(p0=[(0, 1)], p1=[(12, 2), (1, 13)], off=(14, 0)), 6),  # forced short of 1
        (_board(p0=[(0, 1)], p1=[(18, 2), (1, 13)], off=(14, 0)), 6),  # forced short of 2
        (_board(p0=[(0, 1)], p1=[(20, 2), (1, 13)], off=(14, 0)), 5),  # forced short of 3
        (_board(p0=[(0, 2)], p1=[(12, 2), (1, 13)], off=(13, 0)), 6),  # two stop at 6
        (_board(p0=[(5, 15)], p1=[(i, 2) for i in range(6, 13)] + [(0, 1)]), 1),  # no move
        (_board(p0=[(i, 1) for i in range(15)], p1=[(20, 15)]), 1),  # fifteen blots
        (_board(p0=[(0, 3), (5, 3), (9, 3), (13, 3), (16, 3)], p1=[(23, 15)]), 2),
        (_board(p0=[(18, 3), (19, 3), (20, 3), (21, 3), (22, 3)], p1=[(0, 15)]), 1),
    ):
        out += [(cells, 0, die), (_mirror(cells), 1, die)]
    return out


def _tensors(cases, dev):
    cells = torch.tensor(np.stack([c for c, _, _ in cases]), device=dev)
    player = torch.tensor([p for _, p, _ in cases], device=dev)
    die = torch.tensor([d for _, _, d in cases], device=dev)
    return Board(cells), player, die


def _sampled(n, seed, dev):
    boards, players, dice = sample_cases(seed, n, doubles_bias=1.0)
    cells = [np.array(b[0] + b[1] + b[2] + b[3], np.int8) for b in boards]
    return _tensors(list(zip(cells, players, [d[0] for d in dice])), dev)


def _selfplay(dev, batch=512, steps=(6, 14, 30)):
    """Positions of the production 1-ply step from the opening, each with
    all six dice."""
    cfg = _production()
    params = value_net.load_checkpoint(CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    st = vec_env.reset(batch, gen, device=dev)
    seen, done = [], 0
    for s in steps:
        st, _ = rollout.rollout_loop(params, st, 1.0, cfg, s - done, True, gen=gen, device=dev)
        done = s
        seen.append((st.board.data, st.player))
    cells = torch.cat([b for b, _ in seen]).repeat(6, 1)
    player = torch.cat([p for _, p in seen]).repeat(6)
    die = torch.arange(1, 7, device=dev).repeat_interleave(cells.shape[0] // 6)
    return Board(cells), player, die


def _assert_equal(got, want, what):
    assert got.boards.data.shape == want.boards.data.shape, what
    for name in ("boards", "valid", "count", "overflow"):
        a, b = getattr(got, name), getattr(want, name)
        a, b = getattr(a, "data", a), getattr(b, "data", b)
        assert a.dtype == b.dtype, (what, name)
        if not torch.equal(a, b):
            rows = (a != b).reshape(a.shape[0], -1).any(-1).nonzero()[:8, 0].tolist()
            raise AssertionError(f"{what}: {name} differs in games {rows}")


def _both_routes(board, player, die, cfg):
    before = dd_expand.KERNEL.launches
    got = movegen2.enumerate_doubles(board, player, die, cfg)
    assert dd_expand.KERNEL.launches == before + (board.data.shape[0] > 0)
    want = movegen2.enumerate_doubles_plain(board, player, die, cfg)
    torch.cuda.synchronize()
    return got, want


@pytest.fixture(scope="module")
def positions():
    dev = _card()
    return {"selfplay": _selfplay(dev), "sampled": _sampled(517, 3, dev),
            "edges": _tensors(edge_cases(), dev)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(WIDTHS))
def test_kernel_equals_plain_byte_for_byte(name, positions):
    cfg = WIDTHS[name]
    for source, (board, player, die) in positions.items():
        got, want = _both_routes(board, player, die, cfg)
        _assert_equal(got, want, f"{name} on {source}")
    # the overflow, shorts and no-move rows are there to be compared
    got, _ = _both_routes(*positions["edges"], cfg)
    assert bool((got.count == 0).any())
    if name.startswith("narrow"):
        assert bool(got.overflow.any())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 3, 5, 131, 257, 1025])
@pytest.mark.parametrize("name", ["fast", "reply_die1", "reply_die6", "narrow"])
def test_game_counts_off_the_block_size(n, name):
    dev = _card()
    board, player, die = _sampled(n, 100 + n, dev)
    cfg = WIDTHS[name]
    p = dd_expand.plan(n, dd_expand.widths_of(cfg), _cuda_build.sm_count(dev))
    got, want = _both_routes(board, player, die, cfg)
    _assert_equal(got, want, f"{name} n={n} plan={p}")


@pytest.mark.gpu
def test_broadcast_and_strided_operands():
    dev = _card()
    cfg = WIDTHS["fast"]
    board, player, die = _sampled(64, 9, dev)
    wide = torch.zeros((64, 3, 52), dtype=torch.int8, device=dev)
    wide[:, 1] = board.data
    rows = Board(wide[:, 1])  # rows 156 bytes apart
    for p, d in ((player, die), (player.to(torch.int32), die.to(torch.int32)),
                 (torch.tensor(1, device=dev), torch.tensor(4, device=dev).expand(64)),
                 (torch.zeros(64, dtype=torch.int64, device=dev), 6)):
        got = movegen2.enumerate_doubles(rows, p, d, cfg)
        pp = torch.broadcast_to(torch.as_tensor(p, device=dev), (64,)).long()
        dd = torch.broadcast_to(torch.as_tensor(d, device=dev), (64,)).long()
        want = movegen2.enumerate_doubles_plain(board, pp, dd, cfg)
        _assert_equal(got, want, f"player {p.dtype if hasattr(p, 'dtype') else p}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fast", "full", "reply_die2"])
def test_kernel_inside_a_captured_graph(name):
    """Captured once on static inputs, replayed on three other position
    sets copied in: each replay equals the plain chain; the launch is
    counted per replay."""
    dev = _card()
    cfg = WIDTHS[name]
    n = 300
    board, player, die = _sampled(n, 40, dev)
    static = (board.data.clone(), player.clone(), die.clone())
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        movegen2.enumerate_doubles(Board(static[0]), static[1], static[2], cfg)  # warm-up
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with P.GraphLaunches() as held, torch.cuda.graph(graph, stream=stream):
        out = movegen2.enumerate_doubles(Board(static[0]), static[1], static[2], cfg)
    assert held.per_replay == {dd_expand.KERNEL: 1}
    for seed in (41, 42, 43):
        board, player, die = _sampled(n, seed, dev)
        for dst, src in zip(static, (board.data, player, die)):
            dst.copy_(src)
        before = dd_expand.KERNEL.launches
        graph.replay()
        held.replayed()
        assert dd_expand.KERNEL.launches == before + 1
        want = movegen2.enumerate_doubles_plain(board, player, die, cfg)
        torch.cuda.synchronize()
        _assert_equal(out, want, f"{name} replay {seed}")


# the attribution check, in an interpreter of its own: late in a long test
# process torch.profiler has been seen to collect no device event at all
_ATTRIBUTION = """
import sys, torch
from tests.test_torch_dd_expand_gpu import WIDTHS, _sampled
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling
board, player, die = _sampled(1024, 11, torch.device("cuda"))
call = lambda: movegen2.enumerate_doubles(board, player, die, WIDTHS[sys.argv[1]])
call()
torch.cuda.synchronize()
st = profiling.device_stage_times(call)
print(repr((st.stages, st.attributed_ms, st.traced_ms)))
"""


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fast", "reply_die4"])
def test_the_eager_attribution_sees_the_kernel_in_dd_L1(name):
    """The kernel launches inside its dispatcher op, so torch.profiler links
    it to that op and ``attribute_kernels`` puts its device time under
    ``dd_L1``: no device time of the call is left unattributed, and none
    falls under the kernel's own name."""
    _card()
    root = Path(__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", _ATTRIBUTION, name], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert run.returncode == 0, run.stderr[-3000:]
    stages, attributed_ms, traced_ms = ast.literal_eval(run.stdout.strip().splitlines()[-1])
    assert "dd_L1" in stages and stages["dd_L1"][1] >= 1, stages
    assert not [t for t in stages if "dd_expand" in t], stages
    assert attributed_ms >= 0.95 * traced_ms > 0, (attributed_ms, traced_ms)


def _graphed(cfg, dev, batch, steps, chunk, seed, plain, monkeypatch):
    """A graphed rollout from one state and seed, through the kernel or the
    plain chain; its tracer records."""
    graphs.clear_graphs()
    P.TRACER.reset()
    with monkeypatch.context() as m:
        if plain:
            m.setattr(movegen2, "enumerate_doubles", movegen2.enumerate_doubles_plain)
        params = value_net.load_checkpoint(CKPT, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        st = vec_env.reset(batch, gen, device=dev)
        st, _ = rollout.rollout_loop(params, st, 1.0, cfg, 3, True, gen=gen, device=dev)
        out = rollout.rollout_chunked(params, st, 1.0, cfg, steps, chunk=chunk, gen=gen,
                                      device=dev)
        P.trace_flush()
        torch.cuda.synchronize()
        recs = P.trace_records()
    graphs.clear_graphs()
    return out, recs


@pytest.mark.gpu
@pytest.mark.parametrize("twoply, batch, steps, chunk, per_step", [
    (False, 1024, 8, 4, 1),  # legal_moves_split's doubles sub-batch
    (True, 256, 4, 2, 7),  # merged legal_moves and six reply dice
])
def test_graphed_steps_equal_through_kernel_and_plain_chain(twoply, batch, steps, chunk,
                                                            per_step, monkeypatch):
    dev = _card()
    monkeypatch.setenv(P.TRACE_ENV, "1")
    cfg = _production(twoply)
    kernel, recs = _graphed(cfg, dev, batch, steps, chunk, 5, False, monkeypatch)
    plain, plain_recs = _graphed(cfg, dev, batch, steps, chunk, 5, True, monkeypatch)
    _assert_same(plain, kernel)
    (rec,) = [r for r in recs if r["rollout"] is not None]
    assert rec["counters"].get("dd_kernel_launches") == per_step * steps
    assert rec["counters"].get("dd_plain", 0) == 0
    (prec,) = [r for r in plain_recs if r["rollout"] is not None]
    assert prec["counters"].get("dd_kernel_launches", 0) == 0
    # the plain chain is counted where Python calls it: the eager warm-up
    # chunk and the capture; a replay runs no Python
    assert prec["counters"].get("dd_plain") == 2 * chunk * per_step
    P.TRACER.reset()
