"""The Gram dedup (``MoveGenConfig.nd_sig_dedup=False``), the raw
non-doubles enumeration of the value-first scorer and the ``dd_tier``
handling of ``legal_moves_split``, against the JAX package.

Inputs are made from seeds: random positions, constructed bear-off
positions (chained bear-off collapses) and blot-rich positions (hits and
leapfrogs), the families of tests/test_sig_dedup.py, at the reduced widths
of tests/test_split_planes.py. Every integer and bool result must be
bit-equal; afterstate boards are compared where the valid/keep mask is set
(elsewhere both packages hold whatever their clipped selects give).
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
from mlp_ppo_2ply_multi_tpu.engine import movegen2 as jMG2
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from mlp_ppo_2ply_multi_tpu_torch.oracle import sampling
from tests.helpers import bearoff_doubles_case
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(
    w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48,
    nd_tier=16, nd_wide_div=4, dd_subbatch_div=3, split_planes=True,
)
N = 72  # above 64: legal_moves runs its doubles sub-batch


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _roll(rng, doubles):
    if doubles and rng.random() < 0.3:
        d = rng.randint(1, 6)
        return (d, d)
    a, b = rng.randint(1, 6), rng.randint(1, 6)
    while a == b:
        b = rng.randint(1, 6)
    return (a, b)


def _blotty(rng):
    pts = [[0] * 24, [0] * 24]
    for i, c in enumerate(rng.sample(range(24), 14)):
        pts[i % 2][c] = 1
    return (tuple(pts[0]), tuple(pts[1]), (0, 0), (15 - sum(pts[0]), 15 - sum(pts[1])))


def cases(seed, n=N, doubles=False):
    """(boards int8 [n, 52], players int32 [n], dice int32 [n, 2]): thirds of
    random, bear-off and blot-rich positions."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            b, p = sampling.random_board(rng), rng.randint(0, 1)
        elif kind == 1:
            b, p, _ = bearoff_doubles_case(rng)
        else:
            b, p = _blotty(rng), rng.randint(0, 1)
        out.append((b, p, _roll(rng, doubles)))
    boards = np.array([sum((list(x) for x in b), []) for b, _, _ in out], np.int8)
    return boards, np.array([p for _, p, _ in out], np.int32), np.array(
        [d for _, _, d in out], np.int32)


def both(boards, players, dice):
    j = (jB.Board(jnp.asarray(boards)), jnp.asarray(players), jnp.asarray(dice))
    t = (tB.Board(torch.from_numpy(boards)), torch.from_numpy(players),
         torch.from_numpy(dice))
    return j, t


def cfgs(**kw):
    return jcfg.MoveGenConfig(**{**SMALL, **kw}), tcfg.MoveGenConfig(**{**SMALL, **kw})


def assert_moveset_equal(want, got, what=""):
    for f in ("valid", "count", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), _np(getattr(got, f)),
                                      err_msg=f"{what}{f}")
    m = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(want.boards.data)[m], _np(got.boards.data)[m],
                                  err_msg=f"{what}boards")


@pytest.mark.parametrize("shape", [(6, 40), (2, 3, 24)], ids=["flat", "batched"])
def test_dup_earlier_mask_matches_jax(shape):
    """Packed boards with planted duplicates and a random ok mask: the dup
    mask equals JAX's Gram dedup bit for bit, at every slot."""
    rng = np.random.default_rng(sum(shape))
    k = shape[-1]
    packed = rng.integers(0, 16, (*shape, 52)).astype(np.int8)
    lead = packed.reshape(-1, k, 52)
    for row in lead:  # plant copies of earlier and later boards
        for _ in range(k // 3):
            a, b = rng.choice(k, 2, replace=False)
            row[b] = row[a]
    ok = rng.random(shape) < 0.8
    want = jax.device_get(jax.jit(jMG2._dup_earlier_mask)(jnp.asarray(packed), jnp.asarray(ok)))
    got = tMG2._dup_earlier_mask(torch.from_numpy(packed), torch.from_numpy(ok))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert np.asarray(want).sum() > 0


@pytest.mark.parametrize("tier", [0, 16], ids=["single_pass", "two_tier"])
def test_enumerate_nondoubles_gram_matches_jax(tier):
    (jb, jp, jd), (tb, tp, td) = both(*cases(1))
    jc, tc = cfgs(nd_tier=tier, nd_sig_dedup=False)
    want = jax.device_get(jax.jit(lambda b, p, d: jMG2.enumerate_nondoubles(b, p, d, jc))(
        jb, jp, jd))
    assert_moveset_equal(want, tMG2.enumerate_nondoubles(tb, tp, td, tc))


def test_legal_moves_gram_matches_jax():
    (jb, jp, jd), (tb, tp, td) = both(*cases(2, doubles=True))
    jc, tc = cfgs(nd_sig_dedup=False)
    want = jax.device_get(jax.jit(lambda b, p, d: jMG2.legal_moves(b, p, d, jc))(jb, jp, jd))
    assert_moveset_equal(want, tMG2.legal_moves(tb, tp, td, tc))


def _split_equal(want, got):
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if hasattr(w, "data"):
            w, g = w.data, g.data
        np.testing.assert_array_equal(np.asarray(w), _np(g), err_msg=f)


@pytest.mark.parametrize("sig_dedup,dd_tier", [(False, ()), (True, (8, 8, 8)),
                                               (False, (8, 8, 8))],
                         ids=["gram", "sig_dd_tier", "gram_dd_tier"])
def test_legal_moves_split_matches_jax(sig_dedup, dd_tier):
    """The split planes with the Gram dedup, and with ``dd_tier`` set, which
    JAX's legal_moves_split never reads (the port used to refuse it): every
    field bit-equal, the board planes at their valid slots."""
    (jb, jp, jd), (tb, tp, td) = both(*cases(3, doubles=True))
    jc, tc = cfgs(nd_sig_dedup=sig_dedup, dd_tier=dd_tier)
    want = jax.device_get(jax.jit(lambda b, p, d: jMG2.legal_moves_split(b, p, d, jc))(
        jb, jp, jd))
    got = tMG2.legal_moves_split(tb, tp, td, tc)
    for plane, keep in (("nd_boards", "nd_keep"), ("ndw_boards", "ndw_keep"),
                        ("dd_boards", "dd_valid")):
        m = np.asarray(getattr(want, keep))
        np.testing.assert_array_equal(np.asarray(getattr(want, plane).data)[m],
                                      _np(getattr(got, plane).data)[m], err_msg=plane)
    _split_equal(want._replace(nd_boards=None, ndw_boards=None, dd_boards=None),
                 got._replace(nd_boards=None, ndw_boards=None, dd_boards=None))


def _raw_equal(want, got):
    """Every RawMoves field bit-equal; the per-slot fields (kpair, sig,
    boards) where ``valid`` is set: consumers read them only there, and
    past a row's count each package's select clips its own way (JAX's
    blocked select can land in a pass-B pair block, the port's at the last
    cell)."""
    for f in ("valid", "has_pair", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), _np(getattr(got, f)),
                                      err_msg=f)
    m = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(want.kpair)[m], _np(got.kpair)[m])
    np.testing.assert_array_equal(np.asarray(want.sig)[m], _np(got.sig)[m])
    np.testing.assert_array_equal(np.asarray(want.boards.data)[m], _np(got.boards.data)[m])


@pytest.mark.parametrize("K", [48, 16], ids=["K48", "K16_overflowing"])
def test_enumerate_nondoubles_raw_matches_jax(K):
    (jb, jp, jd), (tb, tp, td) = both(*cases(4))
    want = jax.device_get(jax.jit(
        lambda b, p, d: jMG2.enumerate_nondoubles_raw(b, p, d, K))(jb, jp, jd))
    got = tMG2.enumerate_nondoubles_raw(tb, tp, td, K)
    _raw_equal(want, got)
    assert np.asarray(want.has_pair).any() and not np.asarray(want.has_pair).all()
    if K == 16:
        assert np.asarray(want.overflow).any()


def test_enumerate_nondoubles_raw_batched_and_has_pair_match_jax():
    """The batched raw enumeration on a [n, 4] candidate batch with one roll
    broadcast (the scorer's fan-out), and ``nd_has_pair_exact`` on the
    skip-masked pass-B grid."""
    boards, players, _ = cases(5, 4 * 12)
    boards = boards.reshape(12, 4, 52)
    opp = players[:12]
    jb, tb = jB.Board(jnp.asarray(boards)), tB.Board(torch.from_numpy(boards))
    jo, to = jnp.asarray(opp)[:, None], torch.from_numpy(opp)[:, None]
    want = jax.device_get(jax.jit(lambda b, o: jMG2.enumerate_nondoubles_raw_batched(
        b, o, jnp.asarray([5, 2], jnp.int32), 32))(jb, jo))
    got = tMG2.enumerate_nondoubles_raw_batched(tb, to, torch.tensor([5, 2]), 32)
    _raw_equal(want, got)

    (jb, jp, jd), (tb, tp, td) = both(*cases(6))

    def has_pair(MG2, b, p, d):
        pa, pb, _, _, _ = MG2._nd_candidates(b, p, d)
        skip_b = (~pa.any_pair) & (MG2._popcount(pa.single_valid) == 1)
        return MG2.nd_has_pair_exact(pa, pb.pair_valid & ~skip_b[..., None, None])

    want = jax.device_get(jax.jit(lambda b, p, d: has_pair(jMG2, b, p, d))(jb, jp, jd))
    np.testing.assert_array_equal(np.asarray(want), has_pair(tMG2, tb, tp, td).numpy())


@pytest.mark.parametrize("path", ["enumerate_single", "enumerate_tiered", "legal_moves",
                                  "split"])
def test_sig_dedup_equals_gram_dedup(path):
    """Port only: the signature dedup and the Gram dedup give the same moves
    (JAX shows the same in tests/test_sig_dedup.py)."""
    _, (tb, tp, td) = both(*cases(7, 96, doubles=path in ("legal_moves", "split")))
    sig = tcfg.MoveGenConfig(**{**SMALL, "nd_tier": 0 if path == "enumerate_single" else 16})
    gram = dataclasses.replace(sig, nd_sig_dedup=False)
    if path == "split":
        a, b = (tMG2.legal_moves_split(tb, tp, td, c) for c in (sig, gram))
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if hasattr(x, "data"):
                x, y = x.data, y.data
            assert torch.equal(x, y), f
        return
    fn = tMG2.legal_moves if path == "legal_moves" else tMG2.enumerate_nondoubles
    a, b = fn(tb, tp, td, sig), fn(tb, tp, td, gram)
    for f in ("valid", "count", "overflow"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.boards.data[a.valid], b.boards.data[b.valid])
    raw = tMG2.enumerate_nondoubles_raw(tb, tp, td, sig.nd_dedup_k)
    assert bool((tMG2._popcount(raw.valid) > a.count).any())  # duplicates were dropped
