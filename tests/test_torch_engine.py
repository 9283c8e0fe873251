"""The PyTorch port's core and engine against the JAX package, bit-exact.

Inputs are made with numpy from seeds (tests/helpers.py) and handed to both
packages; every integer result must be identical: copied configs field by
field, board ops and predicates, slot tables, and every SplitMoves field of
``legal_moves_split`` (afterstate boards at valid cells, masks, counts, slot
order and overflow everywhere).
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.core import types as jtypes
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.engine import movegen as jMG
from mlp_ppo_2ply_multi_tpu.engine import movegen2 as jMG2
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.core import types as ttypes
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen as tMG
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from tests.helpers import (
    blocked_doubles_case,
    bearoff_doubles_case,
    collect_no4move_doubles,
    sample_cases,
)

# the reduced widths of tests/test_split_planes.py
SMALL = dict(
    w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48,
    nd_tier=16, nd_wide_div=4, dd_subbatch_div=3, split_planes=True,
)


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

_CONFIGS = [
    ("ModelConfig", lambda m: m.ModelConfig()),
    ("EnvConfig", lambda m: m.EnvConfig()),
    ("MoveGenConfig", lambda m: m.MoveGenConfig()),
    ("MoveGenConfig.fast", lambda m: m.MoveGenConfig.fast()),
    ("TrainConfig", lambda m: m.TrainConfig()),
    ("MeshConfig", lambda m: m.MeshConfig()),
    ("TwoPlyConfig", lambda m: m.TwoPlyConfig()),
    ("TwoPlyConfig.tuned", lambda m: m.TwoPlyConfig.tuned()),
    ("Config", lambda m: m.Config()),
    ("Config.production", lambda m: m.Config.production()),
    ("Config.production_twoply", lambda m: m.Config.production_twoply()),
]


@pytest.mark.parametrize("name,make", _CONFIGS, ids=[c[0] for c in _CONFIGS])
def test_config_copy_equal(name, make):
    want, got = make(jcfg), make(tcfg)
    assert [f.name for f in dataclasses.fields(want)] == [
        f.name for f in dataclasses.fields(got)
    ]
    assert dataclasses.asdict(want) == dataclasses.asdict(got)


def test_types_copy_equal():
    for name in (
        "NUM_POINTS", "BAR", "BEAR_OFF", "NO_MOVE", "CHECKERS_PER_PLAYER",
        "HOME_RANGE", "DIRECTION", "FEATURE_DIM",
    ):
        assert getattr(jtypes, name) == getattr(ttypes, name), name
    for enum_name in ("Player", "BoardStateKind", "WinType"):
        je, te = getattr(jtypes, enum_name), getattr(ttypes, enum_name)
        assert [(m.name, m.value) for m in je] == [(m.name, m.value) for m in te]


# ---------------------------------------------------------------------------
# board
# ---------------------------------------------------------------------------


def _prime_cases():
    """A 5-point prime at every window start for both players, with the
    opponent's checkers on random free points (behind the prime or not)."""
    rng = np.random.default_rng(0)
    boards, players = [], []
    for p in (0, 1):
        for start in range(20):
            for _ in range(2):
                d = np.zeros(52, np.int8)
                own, opp = 24 * p, 24 * (1 - p)
                d[own + start : own + start + 5] = 2
                free = [i for i in range(24) if not start <= i < start + 5]
                d[own + free[rng.integers(len(free))]] += 5
                free = [i for i in free if d[own + i] == 0]
                k = int(rng.integers(1, 6))
                for i in rng.choice(free, size=k, replace=False):
                    d[opp + i] = 1
                d[50 + (1 - p)] = 15 - k
                boards.append(d)
                players.append(p)
    return np.stack(boards), np.asarray(players, np.int32)


def test_board_predicates_bit_exact():
    boards, players, _ = _cases(11, 400)
    pb, pp = _prime_cases()
    boards, players = np.concatenate([boards, pb]), np.concatenate([players, pp])
    jb, tb = jB.Board(_j(boards)), tB.Board(_t(boards))
    jp, tp = _j(players), _t(players)
    np.testing.assert_array_equal(
        np.asarray(jB.initial_board((3,)).data), tB.initial_board((3,), "cpu").data
    )
    for name in (
        "has_won", "on_bar", "all_checkers_home", "board_state_kind",
        "is_gammon", "is_backgammon", "is_closed_out", "has_five_prime",
        "bar_count", "off_count", "player_points",
    ):
        want = np.asarray(getattr(jB, name)(jb, jp))
        got = getattr(tB, name)(tb, tp).numpy()
        np.testing.assert_array_equal(want, got, err_msg=name)
    np.testing.assert_array_equal(
        np.asarray(jB.checker_conservation_ok(jb)), tB.checker_conservation_ok(tb)
    )
    assert torch.equal(tB.unpack_board(tB.pack_board(tb)).data, tb.data)


def test_apply_submove_bit_exact():
    boards, players, dice = _cases(12, 300)
    jb = jB.Board(_j(boards))
    st = jMG.slot_table(jb, _j(players), _j(dice[:, 0]))
    s = np.asarray(st.start)
    e = np.asarray(st.end)
    h = np.asarray(st.hits)
    v = np.asarray(st.valid)
    b27 = np.repeat(boards[:, None], 27, axis=1)
    p27 = np.repeat(players[:, None], 27, axis=1)
    want = jB.apply_submove(jB.Board(_j(b27)), _j(p27), _j(s), _j(e), _j(h), _j(v))
    got = tB.apply_submove(tB.Board(_t(b27)), _t(p27), _t(s), _t(e), _t(h), _t(v))
    np.testing.assert_array_equal(np.asarray(want.data), got.data.numpy())


# ---------------------------------------------------------------------------
# movegen helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("die", [1, 2, 3, 4, 5, 6])
def test_slot_tables_bit_exact(die):
    boards, players, _ = _cases(20 + die, 300)
    jb, tb = jB.Board(_j(boards)), tB.Board(_t(boards))
    jp, tp = _j(players), _t(players)
    jd = jnp.full(players.shape, die, jnp.int32)
    td = torch.full(players.shape, die, dtype=torch.int32)

    jst, tst = jMG.slot_table(jb, jp, jd), tMG.slot_table(tb, tp, td)
    for f in jst._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jst, f)), getattr(tst, f).numpy(), err_msg=f
        )
    np.testing.assert_array_equal(
        np.asarray(jMG.farthest_point(jb, jp)), tMG.farthest_point(tb, tp).numpy()
    )
    jctx, tctx = jMG.slot_ctx(jb, jp, jd), tMG.slot_ctx(tb, tp, td)
    for f in jctx._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jctx, f)), getattr(tctx, f).numpy(), err_msg=f
        )
    # slot_valid on the root's children (the way movegen2 uses it)
    b27 = jMG.board_expand(jb, 27)
    kids = jB.apply_submove(b27, jp[:, None], jst.start, jst.end, jst.hits, jst.valid)
    d2 = 7 - die
    jv, jl = jMG.slot_valid(
        kids, jp[:, None], jnp.full((len(players), 1), d2, jnp.int32),
        jMG.ctx_entry_axis(jMG.slot_ctx(jb, jp, jnp.full_like(jd, d2))),
    )
    tkids = tB.Board(_t(np.asarray(kids.data)))
    tv, tl = tMG.slot_valid(
        tkids, tp[:, None], torch.full((len(players), 1), d2),
        tMG.ctx_entry_axis(tMG.slot_ctx(tb, tp, torch.full_like(td, d2))),
    )
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    # slot_params at every slot index, valid or not
    slots = np.broadcast_to(np.arange(27, dtype=np.int32), (len(players), 27))
    jpar = jMG.slot_params(kids, jp[:, None], jd[:, None], _j(slots))
    tpar = tMG.slot_params(tkids, tp[:, None], td[:, None], _t(slots))
    for a, b in zip(jpar, tpar):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,width", [(1512, 96), (37, 64), (256, 8)])
def test_select_set_bits_matches_at_ok_slots(n, width):
    rng = np.random.default_rng(n)
    valid = rng.random((64, n)) < rng.random((64, 1)) * 0.2
    jidx, jok = jMG2._select_set_bits(_j(valid), width)
    tidx, tok = tMG2._select_set_bits(_t(valid), width)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())


# ---------------------------------------------------------------------------
# legal_moves_split
# ---------------------------------------------------------------------------

_SPLIT_MASKS = (
    "nd_keep", "ndw_keep", "ndw_in", "ndw_slot", "dd_valid", "dd_in",
    "dd_slot", "valid", "count", "overflow",
)
_SPLIT_BOARDS = (
    ("nd_boards", "nd_keep"),
    ("ndw_boards", "ndw_keep"),
    ("dd_boards", "dd_valid"),
)


def _run_split(boards, players, dice, mcfg_kw):
    jcf = jcfg.MoveGenConfig(**mcfg_kw)
    tcf = tcfg.MoveGenConfig(**mcfg_kw)
    fn = jax.jit(lambda b, p, d: jMG2.legal_moves_split(jB.Board(b), p, d, jcf))
    want = jax.tree.map(np.asarray, fn(_j(boards), _j(players), _j(dice)))
    got = tMG2.legal_moves_split(tB.Board(_t(boards)), _t(players), _t(dice), tcf)
    return want, got


def _assert_split_equal(want, got):
    for f in _SPLIT_MASKS:
        np.testing.assert_array_equal(
            getattr(want, f), getattr(got, f).numpy(), err_msg=f
        )
    for bf, mf in _SPLIT_BOARDS:
        m = getattr(want, mf)
        np.testing.assert_array_equal(
            getattr(want, bf).data[m], getattr(got, bf).data.numpy()[m], err_msg=bf
        )


def _adversarial_batch(seed, n):
    """No-4-move doubles, raw blocked / bear-off doubles families, and random
    non-double positions to fill the batch (the doubles sub-batch holds
    n/div games)."""
    rng = random.Random(seed)
    cases = collect_no4move_doubles(seed, 24)
    cases += [blocked_doubles_case(rng) for _ in range(12)]
    cases += [bearoff_doubles_case(rng) for _ in range(12)]
    boards = [c[0] for c in cases]
    players = [c[1] for c in cases]
    dice = [(c[2], c[2]) for c in cases]
    fb, fp, fd = sample_cases(seed + 1, n - len(cases))
    boards += fb
    players += fp
    dice += [(a, a % 6 + 1) if a == b else (a, b) for a, b in fd]
    return (
        _np_boards(boards),
        np.asarray(players, np.int32),
        np.asarray(dice, np.int32),
    )


@pytest.mark.parametrize("widths", ["small", "fast"])
def test_legal_moves_split_bit_exact_random(widths):
    kw = SMALL if widths == "small" else dataclasses.asdict(jcfg.MoveGenConfig.fast())
    boards, players, dice = _cases(31, 256, doubles_bias=0.15)
    want, got = _run_split(boards, players, dice, kw)
    _assert_split_equal(want, got)
    assert got.count.dtype == torch.int32
    assert got.nd_boards.data.dtype == torch.int8


@pytest.mark.parametrize("widths", ["small", "fast"])
def test_legal_moves_split_bit_exact_adversarial_doubles(widths):
    kw = SMALL if widths == "small" else dataclasses.asdict(jcfg.MoveGenConfig.fast())
    boards, players, dice = _adversarial_batch(41, 256)
    want, got = _run_split(boards, players, dice, kw)
    _assert_split_equal(want, got)
    # the families reach the doubles plane's forced-shorter records
    assert int(got.dd_in.sum()) >= 48
