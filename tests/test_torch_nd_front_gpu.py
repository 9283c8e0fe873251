"""The non-doubles front kernel (``ops.nd_front``, D3) on the card against
the plain chain (``movegen2.nd_front_plain``): all five outputs byte for
byte, invalid children and cells included.

* Positions: the production 1-ply step's self-play positions at B = 4096 and
  the 2-ply step's at B = 1024, each with the dice it rolled; the oracle's
  sampled positions; built positions (bar entries against blocked points,
  bear-offs through the farthest and the exact slot, no legal move, a forced
  single move that zeroes pass B), each for both players.
* Game counts 0, 1, 33 and others off the block size; broadcast and strided
  operands.
* Inside a captured CUDA graph, replayed on new inputs: the launch counts
  once a replay.
* ``enumerate_nondoubles`` and ``legal_moves_split`` give the same bytes
  through the kernel and through the plain chain put in its place.
* Under torch.profiler: the kernel's device time attributed to ``nd_front``.
* A graphed 1-ply chunk of the production step and a graphed 2-ply step,
  through the kernel and through the plain chain: identical trajectories and
  states; the tracer's record counts one launch a step and no plain call.
* The production steps hand the kernel players 0 and 1 and dice 1..6 (it
  reads a die outside 1..6 as the nearest face, unchecked).
* The benchmark cells' traced eager step, after a profiled update as the
  harness runs it: torch.profiler records the front kernel and every B2
  and doubles kernel launch of the step.

These tests need a CUDA card and skip elsewhere (the kernel has no CPU
mode). The file imports torch, the port and the benchmark only, so on the
card it runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_nd_front_gpu.py
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import _cuda_build, nd_front
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P
from tests.test_torch_graph_gpu import _assert_same, _production
from tests.test_torch_kernel_gpu import CKPT, _card
from tests.test_torch_nd_front import edge_cases, sampled, tensors

FIELDS = ("b1a", "b1b", "valid", "d_hi", "d_lo")


def _selfplay(dev, batch, twoply, steps=(3, 9, 24)):
    """Positions of the production step (1-ply or 2-ply) from the opening,
    each with the dice it rolled, after each of ``steps`` steps."""
    cfg = _production(twoply)
    params = value_net.load_checkpoint(CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    st = vec_env.reset(batch, gen, device=dev)
    seen, done = [], 0
    for s in steps:
        st, _ = rollout.rollout_loop(params, st, 1.0, cfg, s - done, True, gen=gen, device=dev)
        done = s
        seen.append((st.board.data, st.player, st.dice))
    return [(Board(b.clone()), p.clone(), d.clone()) for b, p, d in seen]


def _plain(board, player, dice):
    """The plain chain with the kernel's operands and outputs (tensors)."""
    out = movegen2.nd_front_plain(Board(board), player, dice)
    return tuple(getattr(x, "data", x) for x in out)


def _assert_equal(got, want, what):
    for name, a, b in zip(FIELDS, got, want):
        a, b = getattr(a, "data", a), getattr(b, "data", b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name, a.shape, b.shape)
        if not torch.equal(a, b):
            rows = (a != b).reshape(a.shape[0], -1).any(-1).nonzero()[:8, 0].tolist()
            raise AssertionError(f"{what}: {name} differs in games {rows}")


def _both_routes(board, player, dice):
    n = board.data.shape[0]
    before = nd_front.KERNEL.launches
    got = movegen2.nd_front(board, player, dice)
    assert nd_front.KERNEL.launches == before + (n > 0)
    fp = torch.broadcast_to(torch.as_tensor(player, device=board.data.device).long(), (n,))
    fd = torch.broadcast_to(torch.as_tensor(dice, device=board.data.device).long(), (n, 2))
    want = movegen2.nd_front_plain(board, fp, fd)
    torch.cuda.synchronize()
    return got, want


@pytest.fixture(scope="module")
def positions():
    dev = _card()
    out = {f"selfplay_1ply_{i}": s for i, s in enumerate(_selfplay(dev, 4096, False))}
    out.update({f"selfplay_2ply_{i}": s for i, s in enumerate(_selfplay(dev, 1024, True))})
    out["sampled"] = sampled(517, 3, dev)
    out["edges"] = tensors(edge_cases(), dev)
    return out


@pytest.mark.gpu
def test_kernel_equals_plain_byte_for_byte(positions):
    for source, (board, player, dice) in positions.items():
        got, want = _both_routes(board, player, dice)
        _assert_equal(got, want, source)
    # the built rows are there to be compared: no move, a skipped pass B
    got, _ = _both_routes(*positions["edges"])
    assert bool((got[2].sum(-1) == 0).any())
    assert {positions["selfplay_1ply_0"][0].data.shape[0],
            positions["selfplay_2ply_0"][0].data.shape[0]} == {4096, 1024}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 2, 5, 33, 131, 257, 1025, 4099])
def test_game_counts_off_the_block_size(n):
    dev = _card()
    board, player, dice = sampled(max(n, 1), 100 + n, dev)
    board, player, dice = Board(board.data[:n]), player[:n], dice[:n]
    p = nd_front.plan(n, _cuda_build.sm_count(dev))
    got, want = _both_routes(board, player, dice)
    _assert_equal(got, want, f"n={n} plan={p}")


@pytest.mark.gpu
def test_broadcast_and_strided_operands():
    dev = _card()
    board, player, dice = sampled(64, 9, dev)
    wide = torch.zeros((64, 3, 52), dtype=torch.int8, device=dev)
    wide[:, 1] = board.data
    rows = Board(wide[:, 1])  # rows 156 bytes apart
    swapped = dice.flip(-1)  # d_hi first: the other order of the same roll
    cols = torch.zeros((64, 4), dtype=torch.int64, device=dev)
    cols[:, 0], cols[:, 2] = dice[:, 0], dice[:, 1]
    for p, d in ((player, dice), (player.to(torch.int32), dice.to(torch.int32)),
                 (torch.tensor(1, device=dev), torch.tensor([6, 3], device=dev)),
                 (player, swapped), (player, cols[:, ::2])):
        got = movegen2.nd_front(rows, p, d)
        pp = torch.broadcast_to(torch.as_tensor(p, device=dev), (64,)).long()
        dd = torch.broadcast_to(torch.as_tensor(d, device=dev), (64, 2)).long()
        want = movegen2.nd_front_plain(board, pp, dd)
        torch.cuda.synchronize()
        _assert_equal(got, want, f"player {tuple(p.shape)}, dice strides {d.stride()}")


@pytest.mark.gpu
def test_kernel_inside_a_captured_graph():
    """Captured once on static inputs, replayed on three other position
    sets copied in: each replay equals the plain chain; the launch is
    counted per replay."""
    dev = _card()
    n = 300
    board, player, dice = sampled(n, 40, dev)
    static = (board.data.clone(), player.clone(), dice.clone())
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        movegen2.nd_front(Board(static[0]), static[1], static[2])  # warm-up
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with P.GraphLaunches() as held, torch.cuda.graph(graph, stream=stream):
        out = movegen2.nd_front(Board(static[0]), static[1], static[2])
    assert held.per_replay == {nd_front.KERNEL: 1}
    for seed in (41, 42, 43):
        board, player, dice = sampled(n, seed, dev)
        for dst, src in zip(static, (board.data, player, dice)):
            dst.copy_(src)
        before = nd_front.KERNEL.launches
        graph.replay()
        held.replayed()
        assert nd_front.KERNEL.launches == before + 1
        want = movegen2.nd_front_plain(board, player.long(), dice.long())
        torch.cuda.synchronize()
        _assert_equal(out, want, f"replay {seed}")


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["enumerate_nondoubles", "legal_moves_split", "legal_moves"])
def test_enumerations_equal_through_kernel_and_plain_chain(what, positions, monkeypatch):
    fast = MoveGenConfig.fast()
    fn = {"enumerate_nondoubles": movegen2.enumerate_nondoubles,
          "legal_moves_split": movegen2.legal_moves_split,
          "legal_moves": movegen2.legal_moves}[what]
    for source in ("selfplay_1ply_1", "selfplay_2ply_2", "sampled", "edges"):
        board, player, dice = positions[source]
        before = nd_front.KERNEL.launches
        got = fn(board, player, dice, fast)
        assert nd_front.KERNEL.launches == before + 1
        with monkeypatch.context() as m:
            m.setattr(nd_front, "launch_kernel", _plain)
            want = fn(board, player, dice, fast)
        torch.cuda.synchronize()
        assert nd_front.KERNEL.launches == before + 1
        for name, a in got._asdict().items():
            b = getattr(want, name)
            a, b = getattr(a, "data", a), getattr(b, "data", b)
            assert (a is None) == (b is None), (source, name)
            assert a is None or torch.equal(a, b), (what, source, name)


# the attribution check, in an interpreter of its own: late in a long
# process torch.profiler keeps no record of a session's first ~21 kernels,
# and ``device_stage_times``' lead-in, a call of one kernel here, cannot
# take that loss
_ATTRIBUTION = """
import torch
from tests.test_torch_nd_front import sampled
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling
board, player, dice = sampled(4096, 11, torch.device("cuda"))

def call():
    with profiling.scope("nd_front"):
        return movegen2.nd_front(board, player, dice)

call()
torch.cuda.synchronize()
st = profiling.device_stage_times(call)
print(repr((st.stages, st.attributed_ms, st.traced_ms)))
"""


@pytest.mark.gpu
def test_the_eager_attribution_sees_the_kernel_in_nd_front():
    """The kernel launches inside its dispatcher op, so torch.profiler links
    it to that op and ``attribute_kernels`` puts its device time under the
    caller's ``nd_front`` scope: no device time of the call is left
    unattributed, and none falls under the kernel's own name."""
    _card()
    root = Path(__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", _ATTRIBUTION], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert run.returncode == 0, run.stderr[-3000:]
    stages, attributed_ms, traced_ms = ast.literal_eval(run.stdout.strip().splitlines()[-1])
    assert "nd_front" in stages and stages["nd_front"][1] >= 1, stages
    assert not [t for t in stages if "nd_front_kernel" in t], stages
    assert attributed_ms >= 0.95 * traced_ms > 0, (attributed_ms, traced_ms)


def _graphed(cfg, dev, batch, steps, chunk, seed, plain, monkeypatch):
    """A graphed rollout from one state and seed, through the kernel or the
    plain chain; its tracer records."""
    graphs.clear_graphs()
    P.TRACER.reset()
    with monkeypatch.context() as m:
        if plain:
            m.setattr(nd_front, "launch_kernel", _plain)
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
@pytest.mark.parametrize("twoply, batch, steps, chunk", [
    (False, 4096, 8, 4),  # legal_moves_split's front
    (True, 1024, 4, 2),  # the merged legal_moves of the 2-ply step's own moves
])
def test_graphed_steps_equal_through_kernel_and_plain_chain(twoply, batch, steps, chunk,
                                                            monkeypatch):
    dev = _card()
    monkeypatch.setenv(P.TRACE_ENV, "1")
    cfg = _production(twoply)
    kernel, recs = _graphed(cfg, dev, batch, steps, chunk, 5, False, monkeypatch)
    plain, plain_recs = _graphed(cfg, dev, batch, steps, chunk, 5, True, monkeypatch)
    _assert_same(plain, kernel)
    (rec,) = [r for r in recs if r["rollout"] is not None]
    assert rec["counters"].get("nd_front_kernel_launches") == steps  # one a step
    assert rec["counters"].get("nd_front_plain", 0) == 0
    (prec,) = [r for r in plain_recs if r["rollout"] is not None]
    assert prec["counters"].get("nd_front_kernel_launches", 0) == 0
    # the plain chain is counted where Python calls it: the eager warm-up
    # chunk and the capture; a replay runs no Python
    assert prec["counters"].get("nd_front_plain") == 2 * chunk
    P.TRACER.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("twoply, batch", [(False, 4096), (True, 1024)])
def test_the_production_steps_hand_the_kernel_dice_it_takes(twoply, batch, monkeypatch):
    dev = _card()
    seen = []
    real = movegen2.nd_front

    def spy(board, player, dice):
        n = board.data.shape[0]
        p = torch.broadcast_to(torch.as_tensor(player, device=dev), (n,))
        d = torch.broadcast_to(torch.as_tensor(dice, device=dev), (n, 2))
        seen.append(torch.stack([p.min(), p.max(), d.min(), d.max()]))
        return real(board, player, dice)

    monkeypatch.setattr(movegen2, "nd_front", spy)
    cfg = _production(twoply)
    params = value_net.load_checkpoint(CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    st = vec_env.reset(batch, gen, device=dev)
    rollout.rollout_loop(params, st, 1.0, cfg, 8, True, gen=gen, device=dev)
    lo_hi = torch.stack(seen).cpu()
    assert lo_hi.shape[0] == 8  # one call a step
    assert int(lo_hi[:, 0].min()) == 0 and int(lo_hi[:, 1].max()) == 1
    assert int(lo_hi[:, 2].min()) >= 1 and int(lo_hi[:, 3].max()) <= 6


@pytest.mark.gpu
@pytest.mark.parametrize("workload, tail, doubles", [
    ("prod1ply.train", 2, 1),  # B2's two tiers, the doubles sub-batch
    ("prod2ply.train", 17, 7),  # and the 2-ply replies' 15 tails and 6 doubles calls
])
def test_the_benchmarks_eager_step_records_the_front_and_the_tiers(workload, tail, doubles):
    """``movegen.device_ms_per_step`` reads torch.profiler's kernel records
    of one eager step that the harness profiles after a profiled update:
    the records hold the front kernel's one launch and each B2 and doubles
    kernel launch of the step, and the step's move generation owns device
    time."""
    from benchmark import harness
    from benchmark import trace as T

    dev = _card()
    files = harness.cell_files(workload)
    cell = harness.driver(files.traffic["kind"]).Cell(
        dict(files.config), dict(files.traffic), 2**31 + 11, dev, harness.REPO)
    for _ in range(2):  # the first captures the rollout's graph
        cell.work()
    cell.profiled(1)
    out = cell.eager_step()
    by = out["by_name"]
    launches = {k: T.kernel_seconds(by, f"{k}_kernel")[1] for k in ("nd_front", "nd_tail",
                                                                     "dd_expand")}
    assert launches == {"nd_front": 1, "nd_tail": tail, "dd_expand": doubles}, by
    assert out["movegen"] > 0 and out["attributed"] > 0
    graphs.clear_graphs()
