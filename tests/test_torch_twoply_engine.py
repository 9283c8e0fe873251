"""The port's 2-ply engine pieces against the JAX package, bit-exact.

Inputs are made with numpy from seeds (tests/helpers.py) and handed to both
packages. Covered: ``slot_stats``/``slot_valid_stats``, ``die_tables``,
``die_ctxs``, ``_run_pass_pre`` (full table, root context, precomputed
stats), the batched non-doubles and doubles enumerations the 2-ply scorer
runs on [n, 4] candidate batches, the merged ``legal_moves`` (whole-batch
and sub-batch doubles), and the fused non-doubles tail's plain version
against JAX's Pallas kernel in interpret mode and against JAX's
``movegen2._nd_tail``. Integer results must be identical; afterstate boards
are compared where the valid/keep mask is set (elsewhere both packages hold
whatever their clipped selects give).
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.engine import movegen as jMG
from mlp_ppo_2ply_multi_tpu.engine import movegen2 as jMG2
from mlp_ppo_2ply_multi_tpu.experimental import nd_tail as jND
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen as tMG
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail as tND
from tests.helpers import (
    bearoff_doubles_case,
    blocked_doubles_case,
    collect_no4move_doubles,
    sample_cases,
)
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(
    w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48,
    nd_tier=16, nd_wide_div=4, dd_subbatch_div=3, split_planes=True,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _np_boards(boards):
    return np.array(
        [list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
        dtype=np.int8,
    )


def _cases(seed, n, doubles_bias=0.0):
    boards, players, dice = sample_cases(seed, n, doubles_bias)
    return (
        _np_boards(boards),
        np.asarray(players, np.int32),
        np.asarray(dice, np.int32),
    )


def _assert_tree_equal(want, got, what):
    """Field-by-field equality of two NamedTuple trees (JAX vs port)."""
    if hasattr(want, "_fields"):
        for f in want._fields:
            _assert_tree_equal(getattr(want, f), getattr(got, f), f"{what}.{f}")
    else:
        np.testing.assert_array_equal(np.asarray(want), _np(got), err_msg=what)


def _assert_moveset_equal(want, got, what):
    np.testing.assert_array_equal(np.asarray(want.valid), _np(got.valid), err_msg=what)
    np.testing.assert_array_equal(np.asarray(want.count), _np(got.count), err_msg=what)
    np.testing.assert_array_equal(
        np.asarray(want.overflow), _np(got.overflow), err_msg=what
    )
    m = np.asarray(want.valid)
    np.testing.assert_array_equal(
        np.asarray(want.boards.data)[m], _np(got.boards.data)[m], err_msg=what
    )


# ---------------------------------------------------------------------------
# slot stats, die tables, passes, batched enumerations (the scorer's path)
# ---------------------------------------------------------------------------

N_GAMES = 48
ND_ROLLS = ((5, 2), (6, 1), (3, 4), (1, 2))
DD_DIES = (1, 2, 4, 6)
REPLY = dict(SMALL, nd_tier=0, dd_subbatch_div=0, nd_dedup_k=32, a_max=32, w2=32, w3=32, w4=32)
DD_WIDTHS = {1: (16, 32, 32, 32), 2: (16, 32, 32, 32), 4: (16, 32, 48, 48), 6: (16, 32, 48, 48)}


def _candidate_batch(seed):
    """[N_GAMES, 4] candidate boards (4 random positions per game, all with
    the same side to reply) and the replying player per game."""
    boards, players, _ = _cases(seed, 4 * N_GAMES)
    return boards.reshape(N_GAMES, 4, 52), players[:N_GAMES]


def _jax_scorer_pieces(boards, opp, mods):
    """What the JAX 2-ply scorer computes per roll, for a few rolls: die
    tables, root contexts, child stats, the (hi-first, lo-first) passes in
    all three _run_pass_pre modes, and the batched reply move sets."""
    B, MG, MGM, MG2 = mods
    mg = MG.MoveGenConfig(**REPLY)
    bd = B.Board(boards)
    opp_k = opp[..., None]
    s1_all, b1_all = MG2.die_tables(bd, opp_k)
    ctx_all = MG2.die_ctxs(bd, opp_k)
    stats_all = MGM.slot_stats(b1_all, opp_k[None, ..., None])
    at = lambda t, i: jax.tree.map(lambda a: a[i], t)
    out = {"s1_all": s1_all, "b1_all": b1_all, "ctx_all": ctx_all}
    for r0, r1 in ND_ROLLS:
        hi, lo = max(r0, r1), min(r0, r1)
        d_hi = jnp.full(bd.batch_shape, hi, jnp.int32)
        d_lo = jnp.full(bd.batch_shape, lo, jnp.int32)
        passes = []
        for first, second, d2 in ((hi, lo, d_lo), (lo, hi, d_hi)):
            s1, b1 = at(s1_all, first - 1), at(b1_all, first - 1)
            ctx = at(ctx_all, second - 1)
            p_stats = MG2._run_pass_pre(
                s1, b1, opp_k, d2, ctx=ctx, stats=at(stats_all, first - 1)
            )
            out[f"pass{first}{second}_ctx"] = MG2._run_pass_pre(s1, b1, opp_k, d2, ctx=ctx)
            out[f"pass{first}{second}_table"] = MG2._run_pass_pre(s1, b1, opp_k, d2)
            out[f"pass{first}{second}_stats"] = p_stats
            passes.append(p_stats)
        dice = jnp.broadcast_to(jnp.asarray([r0, r1], jnp.int32), (*bd.batch_shape, 2))
        out[f"nd{r0}{r1}"] = MG2.enumerate_nondoubles_batched(
            bd, opp_k, dice, mg, passes=tuple(passes)
        )
    for d in DD_DIES:
        w2, w3, w4, am = DD_WIDTHS[d]
        mgd = dataclasses.replace(mg, w2=w2, w3=w3, w4=w4, a_max=am, nd_dedup_k=min(32, am))
        die = jnp.full(bd.batch_shape, d, jnp.int32)
        out[f"dd{d}"] = MG2.enumerate_doubles_batched(
            bd, opp_k, die, mgd, s1=at(s1_all, d - 1)
        )
    return out


@pytest.fixture(scope="module")
def scorer_pieces():
    boards, opp = _candidate_batch(5)
    jmods = (jB, jcfg, jMG, jMG2)
    fn = jax.jit(lambda b, o: _jax_scorer_pieces(b, o, jmods))
    want = jax.device_get(fn(jnp.asarray(boards), jnp.asarray(opp)))
    tmods = (tB, tcfg, tMG, tMG2)
    got = _torch_scorer_pieces(_t(boards), _t(opp), tmods)
    return want, got


def _torch_scorer_pieces(boards, opp, mods):
    """The port's side of ``_jax_scorer_pieces``, written the same way."""
    B, MG, MGM, MG2 = mods
    mg = MG.MoveGenConfig(**REPLY)
    bd = B.Board(boards)
    opp_k = opp[..., None]
    s1_all, b1_all = MG2.die_tables(bd, opp_k)
    ctx_all = MG2.die_ctxs(bd, opp_k)
    stats_all = MGM.slot_stats(b1_all, opp_k[None, ..., None])
    at = lambda t, i: MG2._tmap(lambda a: a[i], t)
    out = {"s1_all": s1_all, "b1_all": b1_all, "ctx_all": ctx_all}
    for r0, r1 in ND_ROLLS:
        hi, lo = max(r0, r1), min(r0, r1)
        d_hi = torch.full(bd.batch_shape, hi)
        d_lo = torch.full(bd.batch_shape, lo)
        passes = []
        for first, second, d2 in ((hi, lo, d_lo), (lo, hi, d_hi)):
            s1, b1 = at(s1_all, first - 1), at(b1_all, first - 1)
            ctx = at(ctx_all, second - 1)
            p_stats = MG2._run_pass_pre(
                s1, b1, opp_k, d2, ctx=ctx, stats=at(stats_all, first - 1)
            )
            out[f"pass{first}{second}_ctx"] = MG2._run_pass_pre(s1, b1, opp_k, d2, ctx=ctx)
            out[f"pass{first}{second}_table"] = MG2._run_pass_pre(s1, b1, opp_k, d2)
            out[f"pass{first}{second}_stats"] = p_stats
            passes.append(p_stats)
        out[f"nd{r0}{r1}"] = MG2.enumerate_nondoubles_batched(
            bd, opp_k, torch.tensor([r0, r1]), mg, passes=tuple(passes)
        )
    for d in DD_DIES:
        w2, w3, w4, am = DD_WIDTHS[d]
        mgd = dataclasses.replace(mg, w2=w2, w3=w3, w4=w4, a_max=am, nd_dedup_k=min(32, am))
        out[f"dd{d}"] = MG2.enumerate_doubles_batched(
            bd, opp_k, torch.tensor(d), mgd, s1=at(s1_all, d - 1)
        )
    return out


def test_die_tables_and_ctxs_bit_exact(scorer_pieces):
    want, got = scorer_pieces
    for name in ("s1_all", "b1_all", "ctx_all"):
        _assert_tree_equal(want[name], got[name], name)
    assert tuple(got["b1_all"].data.shape) == (6, N_GAMES, 4, 27, 52)


@pytest.mark.parametrize("mode", ["table", "ctx", "stats"])
def test_run_pass_pre_bit_exact(scorer_pieces, mode):
    want, got = scorer_pieces
    names = [k for k in want if k.startswith("pass") and k.endswith(mode)]
    assert len(names) == 2 * len(ND_ROLLS)
    for name in names:
        _assert_tree_equal(want[name], got[name], name)
        # the three second-ply modes agree with each other
        _assert_tree_equal(want[name], got[name[: -len(mode)] + "table"], name)


def test_enumerate_batched_bit_exact(scorer_pieces):
    want, got = scorer_pieces
    for name in [f"nd{r0}{r1}" for r0, r1 in ND_ROLLS] + [f"dd{d}" for d in DD_DIES]:
        _assert_moveset_equal(want[name], got[name], name)
        assert tuple(got[name].valid.shape[:2]) == (N_GAMES, 4)
    # the positions reach replies, wide and empty reply sets
    counts = np.concatenate([np.asarray(want[f"nd{r}{s}"].count).ravel() for r, s in ND_ROLLS])
    assert counts.max() > 16 and (counts == 0).any()


@pytest.mark.parametrize("die", [1, 3, 6])
def test_slot_valid_stats_bit_exact(die):
    boards, players, _ = _cases(60 + die, 300)
    jb, tb = jB.Board(jnp.asarray(boards)), tB.Board(_t(boards))
    jp, tp = jnp.asarray(players), _t(players)
    jst, tst = jMG.slot_stats(jb, jp), tMG.slot_stats(tb, tp)
    for jf, tf in zip(jst, tst):
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    jd = jnp.full(players.shape, die, jnp.int32)
    td = torch.full(players.shape, die)
    jctx, tctx = jMG.slot_ctx(jb, jp, jd), tMG.slot_ctx(tb, tp, td)
    jv, jl = jMG.slot_valid_stats(jst, jp, jd, jctx)
    tv, tl = tMG.slot_valid_stats(tst, tp, td, tctx)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(tv.numpy(), tMG.slot_table(tb, tp, td).valid.numpy())


# ---------------------------------------------------------------------------
# merged legal_moves
# ---------------------------------------------------------------------------


def _mixed_batch(seed, n):
    """No-4-move doubles and the blocked / bear-off doubles families, then
    sampled positions with a doubles bias to fill the batch."""
    rng = random.Random(seed)
    cases = collect_no4move_doubles(seed, 8)
    cases += [blocked_doubles_case(rng) for _ in range(4)]
    cases += [bearoff_doubles_case(rng) for _ in range(4)]
    fb, fp, fd = sample_cases(seed + 1, n - len(cases), 0.3)
    return (
        _np_boards([c[0] for c in cases] + fb),
        np.asarray([c[1] for c in cases] + fp, np.int32),
        np.asarray([(c[2], c[2]) for c in cases] + fd, np.int32),
    )


@pytest.mark.parametrize(
    "widths,n", [("small", 48), ("small", 256), ("fast", 256)],
)
def test_legal_moves_merged_bit_exact(widths, n):
    """n <= 64 runs the doubles on the whole batch, n > 64 on the compacted
    sub-batch; the fast widths run the two-tier non-doubles tail."""
    kw = SMALL if widths == "small" else dataclasses.asdict(jcfg.MoveGenConfig.fast())
    boards, players, dice = _mixed_batch(70 + n, n)
    jc, tc = jcfg.MoveGenConfig(**kw), tcfg.MoveGenConfig(**kw)
    fn = jax.jit(lambda b, p, d: jMG2.legal_moves(jB.Board(b), p, d, jc))
    want = jax.device_get(fn(jnp.asarray(boards), jnp.asarray(players), jnp.asarray(dice)))
    got = tMG2.legal_moves(tB.Board(_t(boards)), _t(players), _t(dice), tc)
    _assert_moveset_equal(want, got, f"legal_moves {widths} n={n}")
    assert got.count.dtype == torch.int32 and got.boards.data.dtype == torch.int8
    is_double = dice[:, 0] == dice[:, 1]
    assert (np.asarray(want.count)[is_double] > 0).any()


def test_legal_moves_merged_batch_shape_and_kernel_flag():
    """A [4, 12] batch gives the flat result reshaped, and on the CPU the
    nd_tail_kernel flag changes nothing (the single-pass tail)."""
    boards, players, dice = _cases(81, 48, doubles_bias=0.2)
    kw = dict(SMALL, nd_tier=0)
    tc = tcfg.MoveGenConfig(**kw)
    tk = tcfg.MoveGenConfig(**dict(kw, nd_tail_kernel=True))
    flat = tMG2.legal_moves(tB.Board(_t(boards)), _t(players), _t(dice), tc)
    shaped = tMG2.legal_moves(
        tB.Board(_t(boards.reshape(4, 12, 52))), _t(players.reshape(4, 12)),
        _t(dice.reshape(4, 12, 2)), tk,
    )
    assert tuple(shaped.valid.shape) == (4, 12, flat.valid.shape[-1])
    np.testing.assert_array_equal(flat.valid.numpy(), shaped.valid.reshape(48, -1).numpy())
    np.testing.assert_array_equal(flat.count.numpy(), shaped.count.reshape(48).numpy())
    m = flat.valid.numpy()
    np.testing.assert_array_equal(
        flat.boards.data.numpy()[m], shaped.boards.data.reshape(48, -1, 52).numpy()[m]
    )


# ---------------------------------------------------------------------------
# the fused non-doubles tail (kernel B2) — plain version
# ---------------------------------------------------------------------------


def _tail_inputs(seed, n):
    """The tail's inputs from the JAX front half on sampled non-double
    decisions: (valid [n, 1512], b1a, b1b, b0, player, d_hi, d_lo)."""
    boards, players, dice = _cases(seed, n)
    fn = jax.jit(lambda b, p, d: jMG2._nd_candidates(jB.Board(b), p, d))
    pa, pb, valid, d_hi, d_lo = jax.device_get(
        fn(jnp.asarray(boards), jnp.asarray(players), jnp.asarray(dice))
    )
    return (
        np.asarray(valid), np.asarray(pa.b1.data), np.asarray(pb.b1.data), boards,
        players, np.asarray(d_hi, np.int32), np.asarray(d_lo, np.int32),
    )


def _plain(inputs, K, a_max):
    return tND.nd_tail_plain(*(_t(x) for x in inputs), K, a_max)


def _assert_tail_equal(want_after, want_keep, want_pct, got, what):
    after, keep, _, pct, _ = got
    np.testing.assert_array_equal(np.asarray(want_keep), keep.numpy(), err_msg=what)
    np.testing.assert_array_equal(np.asarray(want_pct), pct.numpy(), err_msg=what)
    m = np.asarray(want_keep)
    np.testing.assert_array_equal(
        np.asarray(want_after)[m], after.numpy()[m], err_msg=what
    )


def test_nd_tail_plain_matches_jax_pallas_kernel_interpret():
    """The port's plain version against the TPU kernel itself, run by
    Pallas's interpreter on 64 rows at the reply path's K = a_max = 96."""
    inputs = _tail_inputs(91, 64)
    K = a_max = 96
    want = jax.device_get(
        jND.nd_tail_fused(*(jnp.asarray(x) for x in inputs), K, a_max, interpret=True)
    )
    got = _plain(inputs, K, a_max)
    _assert_tail_equal(want[0], want[1], want[3], got, "vs pallas")
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())  # n_pre
    np.testing.assert_array_equal(np.asarray(want[4]), got[4].numpy())  # kpair
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
    # the sample reaches duplicates, the max-submove filter and empty rows
    n_pre = got[2].numpy()
    assert (got[3].numpy() < np.minimum(n_pre, K)).any() and (n_pre == 0).any()


@pytest.mark.parametrize("K,a_max", [(96, 96), (24, 16), (288, 64)])
def test_nd_tail_plain_matches_jax_nd_tail(K, a_max):
    """Against JAX's XLA tail (movegen2._nd_tail) at widths that cut the
    candidates (K = 24), cap the survivors (a_max = 16, 64) or hold them all
    (K = 288)."""
    inputs = _tail_inputs(92, 256)
    valid, b1a, b1b, b0, player, d_hi, d_lo = (jnp.asarray(x) for x in inputs)
    fn = jax.jit(
        lambda *a: jMG2._nd_tail(
            jB.Board(a[3]), jB.Board(a[1]), jB.Board(a[2]), a[0], a[4], a[5], a[6],
            K, a_max,
        )
    )
    after, keep, pct = jax.device_get(fn(valid, b1a, b1b, b0, player, d_hi, d_lo))
    got = _plain(inputs, K, a_max)
    _assert_tail_equal(after.data, keep, pct, got, f"K={K} a_max={a_max}")
    np.testing.assert_array_equal(inputs[0].sum(-1), got[2].numpy())


def test_nd_tail_fused_routes_cpu_to_plain_and_refuses_other_devices():
    inputs = _tail_inputs(93, 16)
    before = tND.KERNEL.launches
    got = tND.nd_tail_fused(*(_t(x) for x in inputs), 96, 96)
    want = _plain(inputs, 96, 96)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tND.KERNEL.launches == before  # the CPU path launches nothing
    meta = [_t(x).to("meta") for x in inputs]
    with pytest.raises(ValueError):
        tND.nd_tail_fused(*meta, 96, 96)
    bad = [_t(x) for x in inputs]
    bad[1] = bad[1][:, :26]
    with pytest.raises(ValueError):
        tND.nd_tail_fused(*bad, 96, 96)
