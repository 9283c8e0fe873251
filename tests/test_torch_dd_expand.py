"""The doubles kernel's host side on the CPU (``ops.dd_expand``).

* The launch planner: a warp or a block of 256 threads a game by the widths,
  the games a block by the widths and the game count, each game's shared
  memory by the widths (the kernel's layout, mirrored), and the opt-in above
  48 KB, at the widths the port runs: ``fast()`` (the 1-ply sub-batch),
  ``Config()`` (merged legal moves, evaluation, the tools) and the tuned
  2-ply reply widths.
* ``bound``: the bytes in and out.
* A CPU tensor takes the plain chain: the kernel is neither planned nor
  launched, and the outputs are the plain chain's.
* The tracer counts the kernel's launches (eager and replayed) and the
  plain chain's calls on a card by update, and ``trace_summary`` reads them.

The kernel itself on the card: tests/test_torch_dd_expand_gpu.py.
"""
import dataclasses

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig, TwoPlyConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.ops import _cuda_build, dd_expand, fused_value
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P

FAST = dd_expand.widths_of(MoveGenConfig.fast())
FULL = dd_expand.widths_of(MoveGenConfig())
REPLY = {die: w for die, w in enumerate(
    [(16, *x) for x in TwoPlyConfig.tuned().dd_reply_widths], start=1)}
H100_SMS = 132


def test_the_ports_widths_are_the_planned_ones():
    assert FAST == (16, 96, 224, 448, 448)
    assert FULL == (16, 128, 288, 512, 512)
    assert REPLY[1] == REPLY[3] == (16, 64, 96, 64, 64)
    assert REPLY[4] == REPLY[6] == (16, 64, 128, 128, 128)


@pytest.mark.parametrize("widths, want", [
    (FAST, 43_952),  # 785 boards: 40,820 B of frontier
    (FULL, 53_072),  # 945 boards: 49,140 B, above the default 48 KB
    (REPLY[1], 13_968),
    (REPLY[6], 19_312),
    ((1, 1, 1, 1, 1), 272 + 16 + 16 + 16 + 64),  # each region rounded up to 16 B
])
def test_shared_memory_of_a_game_by_widths(widths, want):
    got = dd_expand.game_bytes(widths)
    assert got == want and got % 16 == 0
    w1, w2, w3, w4, _ = widths
    boards = (1 + w1 + w2 + w3 + w4) * 52
    assert boards <= got <= boards + 60 * (1 + w1 + w2 + w3 + w4) + 96


@pytest.mark.parametrize("n, widths, team, games, opt_in", [
    (1024, FAST, 256, 1, False),  # the 1-ply step's doubles sub-batch
    (256, FAST, 256, 1, False),  # the 2-ply step's own moves
    (256, FULL, 256, 1, True),  # Config(): 53 KB a block
    (4096, REPLY[1], 32, 3, False),  # the reply calls: three warps' games in 48 KB
    (4096, REPLY[5], 32, 2, False),
    (300, REPLY[5], 32, 2, False),  # n / sms bounds the games a block
    (200, REPLY[2], 32, 1, False),
    (1, REPLY[2], 32, 1, False),
    (1, FAST, 256, 1, False),
    (10_000, (16, 32, 48, 64, 64), 32, 4, False),  # at most four games a block
    (10_000, (16, 32, 48, 64, 129), 256, 1, False),  # a_max over 128: a block
])
def test_plan_by_widths_and_game_count(n, widths, team, games, opt_in):
    p = dd_expand.plan(n, widths, H100_SMS)
    assert (p["team"], p["games"], p["opt_in"]) == (team, games, opt_in)
    assert p["smem_bytes"] == games * dd_expand.game_bytes(widths)
    assert p["blocks"] == -(-n // games) and p["blocks"] * games >= n
    assert p["opt_in"] == (p["smem_bytes"] > 48 * 1024)


def test_the_48_kb_opt_in_threshold():
    """A block team opts in exactly when its one game needs more than 48 KB:
    w4 sweeps the frontier across the threshold."""
    seen = set()
    for w4 in range(300, 700, 4):
        widths = (16, 128, 288, w4, 512)
        p = dd_expand.plan(256, widths, H100_SMS)
        assert p["team"] == 256 and p["opt_in"] == (dd_expand.game_bytes(widths) > 49_152)
        seen.add(p["opt_in"])
    assert seen == {False, True}
    # under it: FAST's 43,952 B; over it: Config()'s 53,072 B
    assert not dd_expand.plan(1024, FAST, H100_SMS)["opt_in"]
    assert dd_expand.plan(1024, FULL, H100_SMS)["opt_in"]


@pytest.mark.parametrize("widths", [(0, 96, 224, 448, 448), (16, 96, 224, 2049, 448),
                                    (16, 96, 224, 448, 0), (16, 2048, 2048, 2048, 2048)])
def test_plan_refuses_widths_it_cannot_take(widths):
    with pytest.raises(ValueError):
        dd_expand.plan(1024, widths, H100_SMS)


def test_bound_counts_the_bytes_in_and_out():
    b = dd_expand.bound(1024, FAST)
    assert b["bytes"] == 1024 * (52 + 8 + 8) + 1024 * (448 * 52 + 448 + 4 + 1)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)


def _cases(n, seed=11):
    boards, players, dice = sample_cases(seed, n, doubles_bias=1.0)
    data = torch.tensor([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
                        dtype=torch.int8)
    return Board(data), torch.tensor(players), torch.tensor([d[0] for d in dice])


@pytest.mark.parametrize("cfg", [MoveGenConfig.fast(),
                                 MoveGenConfig(w1=4, w2=8, w3=12, w4=16, a_max=6)])
def test_a_cpu_tensor_takes_the_plain_chain(cfg, monkeypatch):
    board, player, die = _cases(40)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel route ran on the CPU")

    monkeypatch.setattr(dd_expand, "launch_kernel", no_kernel)
    monkeypatch.setattr(dd_expand, "plan", no_kernel)
    monkeypatch.setenv(P.TRACE_ENV, "1")
    P.TRACER.reset()
    launches = dd_expand.KERNEL.launches
    got = movegen2.enumerate_doubles(board, player, die, cfg)
    want = movegen2.enumerate_doubles_plain(board, player, die, cfg)
    for a, b in zip(got, want):
        assert a is not None and torch.equal(getattr(a, "data", a), getattr(b, "data", b))
    assert got.boards.data.shape == (40, cfg.a_max, 52)
    assert got.count.dtype == torch.int32 and got.overflow.dtype == torch.bool
    assert dd_expand.KERNEL.launches == launches
    assert "dd_plain" not in P.TRACER.counters  # counted on a card only
    P.TRACER.reset()


def test_the_kernel_route_refuses_a_cpu_board():
    board, player, die = _cases(4)
    with pytest.raises(ValueError, match="cuda"):
        dd_expand.launch_kernel(board.data, player, die, FAST)
    with pytest.raises(ValueError):
        dd_expand.launch_kernel(board.data.to(torch.int16), player, die, FAST)


def test_the_launch_op_is_defined_once_and_for_cuda_alone():
    """The kernel launches through the dispatcher op
    ``mlp_ppo_torch::dd_expand`` (so the profiler links it to its scope):
    defined at the first launch and once, writing its four outputs, with no
    CPU body."""
    op = dd_expand._launch_op()
    assert dd_expand._launch_op() is op and len(dd_expand._LIBRARY) == 1
    schema = str(op.default._schema)
    for out in ("Tensor(a!) boards", "Tensor(b!) valid", "Tensor(c!) count",
                "Tensor(d!) overflow"):
        assert out in schema
    board, player, die = _cases(2)
    outs = (torch.empty((2, 3, 52), dtype=torch.int8), torch.empty((2, 3), dtype=torch.bool),
            torch.empty(2, dtype=torch.int32), torch.empty(2, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        op(board.data, player, die, *outs, [1, 2, 2, 3, 3, 32, 1])


def test_a_precomputed_root_table_changes_nothing():
    """``s1`` (``die_tables``' table for the die) gives the table the
    enumeration builds itself, which is why the kernel may ignore it."""
    board, player, die = _cases(24, seed=5)
    cfg = Config().movegen
    s1_all, _ = movegen2.die_tables(board, player)
    s1 = movegen2.SlotTable(*(torch.stack([t[d - 1, i] for i, d in enumerate(die.tolist())])
                              for t in s1_all))
    a = movegen2.enumerate_doubles(board, player, die, cfg, s1=s1)
    b = movegen2.enumerate_doubles(board, player, die, cfg)
    for x, y in zip(a, b):
        assert torch.equal(getattr(x, "data", x), getattr(y, "data", y))


def test_launches_and_plain_calls_counted_by_update(monkeypatch):
    monkeypatch.setenv(P.TRACE_ENV, "1")
    monkeypatch.setattr(dd_expand.KERNEL, "launches", 0)
    P.TRACER.reset()
    held = _cuda_build.GraphLaunches()
    held.per_replay = {dd_expand.KERNEL: 4}  # a chunk graph of four steps
    for update in range(2):
        P.new_update()
        with P.scope("rollout", span=True):
            dd_expand.KERNEL.launches += 1  # an eager step
            for _ in range(3 + update):
                held.replayed()
        P.count("dd_plain", update)
    P.trace_flush()
    recs = P.trace_records()
    assert [r["counters"].get("dd_kernel_launches") for r in recs] == [13, 17]
    assert [r["counters"].get("dd_plain", 0) for r in recs] == [0, 1]
    s = P.trace_summary()
    assert (s["trace/dd_kernel_launches"], s["trace/dd_plain"]) == (17.0, 1.0)
    assert dd_expand.KERNEL.launches == 30
    # tracing off: the kernel's own count goes on, the tracer keeps nothing
    monkeypatch.setenv(P.TRACE_ENV, "0")
    P.TRACER.reset()
    held.replayed()
    assert dd_expand.KERNEL.launches == 34 and dict(P.TRACER.counters) == {}
    P.TRACER.reset()


def test_other_kernels_count_no_tracer_counter(monkeypatch):
    """The tracer reads the doubles kernel's launches alone: another
    kernel's launches, eager and replayed, leave its update counters at 0."""
    monkeypatch.setenv(P.TRACE_ENV, "1")
    P.TRACER.reset()
    k = fused_value.KERNEL
    monkeypatch.setattr(k, "launches", 0)
    held = _cuda_build.GraphLaunches()
    held.per_replay = {k: 15}
    P.new_update()
    with P.scope("rollout", span=True):
        k.launches += 1  # an eager launch
        held.replayed(2)
    P.trace_flush()
    (rec,) = P.trace_records()
    assert k.launches == 31 and rec["counters"] == {
        "dd_kernel_launches": 0, "nd_tail_kernel_launches": 0, "mlp_kernel_launches": 0}
    assert dict(P.TRACER.counters) == {}
    P.TRACER.reset()


def test_reply_configs_reach_the_planned_widths():
    """The unrolled 2-ply scorer's doubles config per die is the one the
    planner sizes (expectimax: w2, w3, w4, a_max from dd_reply_widths)."""
    tw = TwoPlyConfig.tuned()
    mg = Config.production_twoply().movegen
    for die in range(1, 7):
        w2, w3, w4, am = tw.dd_reply_widths[die - 1]
        mgd = dataclasses.replace(mg, w2=w2, w3=w3, w4=w4, a_max=am)
        assert dd_expand.widths_of(mgd) == REPLY[die]
        assert dd_expand.plan(4096, REPLY[die], H100_SMS)["team"] == 32
