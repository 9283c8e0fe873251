"""The two-tier non-doubles tail's route through B2 on the CPU
(``movegen2._nd_two_tier``, ``experimental.nd_tail``).

* With signature dedup each tier is one call of
  ``experimental.nd_tail.nd_tail_fused``, looked up at each call (so a
  replaced module attribute sees it): widths T and K, in
  ``legal_moves_split`` and in the merged ``legal_moves`` at ``fast()`` and
  at reduced widths. The Gram dedup (``nd_sig_dedup=False``) never calls
  it; a tier wider than ``nd_tail.MAX_K`` calls it all the same (the CPU
  computes any width, the card raises).
* The route's outputs are those of the plain ``_nd_tail`` route in every
  output tensor, slots that are not kept included, with wide games past
  tier 2's sub-batch (its overflow branch).
* A CPU call counts neither B2's launches nor the plain tail's runs on a
  card (the counters themselves: tests/test_torch_kernel_seam.py).

The kernel on the card: tests/test_torch_kernel_gpu.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P

FAST = MoveGenConfig.fast()
# reduced widths (those of tests/test_torch_engine.py): most games are wider
# than the tier, more than tier 2's sub-batch holds
SMALL = MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, nd_tier=16,
                      nd_wide_div=4, dd_subbatch_div=3, split_planes=True)
CALLS = {
    "split": lambda b, p, d, cfg: movegen2.legal_moves_split(b, p, d, cfg),
    "merged": lambda b, p, d, cfg: movegen2.legal_moves(b, p, d, cfg),
}


def _cases(n, seed, doubles_bias=0.15):
    boards, players, dice = sample_cases(seed, n, doubles_bias=doubles_bias)
    data = np.array([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
                    dtype=np.int8)
    return Board(torch.from_numpy(data)), torch.tensor(players), torch.tensor(dice)


def _spy(monkeypatch):
    """Replace ``nd_tail.nd_tail_fused`` and ``movegen2._nd_two_tier`` by
    wrappers that record (rows, K) of each fused call and count the
    two-tier calls."""
    seen, tiers = [], []
    fused, two_tier = nd_tail.nd_tail_fused, movegen2._nd_two_tier

    def spy(valid, *a, **k):
        seen.append((valid.shape[0], int(a[6])))
        return fused(valid, *a, **k)

    def count(*a, **k):
        tiers.append(1)
        return two_tier(*a, **k)

    monkeypatch.setattr(nd_tail, "nd_tail_fused", spy)
    monkeypatch.setattr(movegen2, "_nd_two_tier", count)
    return seen, tiers


def _plain_tier(b0, b1a, b1b, valid, player, d_hi, d_lo, width, cfg):
    """A tier on the plain ``_nd_tail``, as the route ran before B2 took it."""
    after, keep, pct, _ = movegen2._nd_tail(
        b0, b1a, b1b, valid, player, d_hi, d_lo, width, cfg.a_max, cfg.nd_sig_dedup)
    return after, keep, movegen2._popcount(valid), pct


def _outputs(x):
    """Every tensor of a MoveSet or SplitMoves, boards as their data."""
    return [getattr(t, "data", t) for t in x]


@pytest.mark.parametrize("call", sorted(CALLS))
@pytest.mark.parametrize("cfg", [FAST, SMALL], ids=["fast", "small"])
def test_each_tier_is_one_fused_call(monkeypatch, call, cfg):
    board, player, dice = _cases(64, 3)
    seen, tiers = _spy(monkeypatch)
    CALLS[call](board, player, dice, cfg)
    wn = max(8, 64 // cfg.nd_wide_div)
    assert len(tiers) == 1
    assert seen == [(64, cfg.nd_tier), (wn, cfg.nd_dedup_k)]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_the_gram_dedup_never_calls_the_fused_tail(monkeypatch, call):
    board, player, dice = _cases(64, 4)
    seen, tiers = _spy(monkeypatch)
    gram = dataclasses.replace(FAST, nd_sig_dedup=False)
    got = CALLS[call](board, player, dice, gram)
    want = CALLS[call](board, player, dice, FAST)
    assert len(tiers) == 2 and seen == [(64, 96), (8, 288)]  # the second call alone
    assert torch.equal(got.valid, want.valid) and torch.equal(got.overflow, want.overflow)


def test_a_tier_wider_than_the_kernel_still_takes_the_fused_tail(monkeypatch):
    """The route reads the dedup alone, not the width: at nd_dedup_k above
    MAX_K both tiers still call the fused tail (on the CPU its plain
    version; on a card the kernel raises, tests/test_torch_kernel_gpu.py)."""
    board, player, dice = _cases(64, 5)
    seen, tiers = _spy(monkeypatch)
    wide = dataclasses.replace(FAST, nd_dedup_k=nd_tail.MAX_K + 24)
    movegen2.legal_moves_split(board, player, dice, wide)
    assert len(tiers) == 1 and seen == [(64, FAST.nd_tier), (8, nd_tail.MAX_K + 24)]


@pytest.mark.parametrize("sig", [True, False], ids=["sig", "gram"])
def test_the_single_pass_takes_the_same_route(monkeypatch, sig):
    """The single full-width pass (``nd_tier`` 0) takes the tiers' route on
    the flattened batch: one fused call at width ``nd_dedup_k`` with
    signature dedup, none with the Gram dedup; a [2, 32] batch gives the
    rows of the flat one."""
    board, player, dice = _cases(64, 8)
    cfg = dataclasses.replace(MoveGenConfig(), nd_sig_dedup=sig)
    flat = movegen2.enumerate_nondoubles(board, player, dice, cfg)
    seen, _ = _spy(monkeypatch)
    shaped = movegen2.enumerate_nondoubles(Board(board.data.reshape(2, 32, -1)),
                                           player.reshape(2, 32), dice.reshape(2, 32, 2), cfg)
    assert seen == ([(64, cfg.nd_dedup_k)] if sig else [])
    for i, (a, b) in enumerate(zip(_outputs(flat), _outputs(shaped))):
        assert b.shape[:2] == (2, 32) and torch.equal(a, b.reshape(a.shape)), i


@pytest.mark.parametrize("call", sorted(CALLS))
@pytest.mark.parametrize("cfg", [FAST, SMALL], ids=["fast", "small"])
def test_the_fused_route_gives_the_plain_routes_bytes(monkeypatch, call, cfg):
    """Every output tensor, slots that are not kept included, against the
    same call with both tiers on the plain ``_nd_tail`` (``_plain_tier``);
    at the small widths with wide games beyond tier 2's sub-batch, so that
    its overflow branch runs."""
    board, player, dice = _cases(96, 6)
    got = CALLS[call](board, player, dice, cfg)
    monkeypatch.setattr(movegen2, "_tier_tail", _plain_tier)
    seen, _ = _spy(monkeypatch)
    want = CALLS[call](board, player, dice, cfg)
    assert seen == []
    for i, (a, b) in enumerate(zip(_outputs(got), _outputs(want))):
        assert a.dtype == b.dtype and torch.equal(a, b), (type(got).__name__, i)
    if cfg is SMALL:
        nd = dice[:, 0] != dice[:, 1]
        _, _, valid, _, _ = movegen2._nd_candidates(board, player.long(), dice.long())
        wide = nd & (valid.sum(-1) > cfg.nd_tier)
        assert int(wide.sum()) > 96 // cfg.nd_wide_div  # past the sub-batch
        assert bool(got.overflow[wide].any())


def test_cpu_calls_count_neither_counter(monkeypatch):
    monkeypatch.setenv(P.TRACE_ENV, "1")
    P.TRACER.reset()
    launches = nd_tail.KERNEL.launches
    board, player, dice = _cases(32, 7)
    P.new_update()
    with P.scope("rollout", span=True):
        movegen2.legal_moves_split(board, player, dice, FAST)
    P.trace_flush()
    (rec,) = P.trace_records()
    assert nd_tail.KERNEL.launches == launches
    assert rec["counters"].get("nd_tail_kernel_launches") == 0
    assert "nd_tail_plain" not in P.TRACER.counters  # counted on a card only
    P.TRACER.reset()
