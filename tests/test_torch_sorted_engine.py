"""The port's sorted reference-order engine against the JAX package, bit-exact.

``engine/movegen.py`` with ``algo="sorted"`` (JAX ``movegen.py:442-891``) and
the board hashes it dedups by (JAX ``board.py:263-326``). Inputs are made
with numpy and the seeded case generators of tests/helpers.py and handed to
both packages; every integer result must be identical:

* ``board_hash`` and ``submove_hash_delta`` at every slot of every die, the
  invalid submoves' too (JAX's out-of-range table reads included);
* ``dedup_compact`` in ``out_idx``, ``out_valid`` and ``out_mfr`` at every
  position, with and without ``flag_rank``, on heavily duplicated hashes
  with invalid entries, ``width`` below and above the survivor count; and
  the segmented scan under it;
* the sorted ``legal_moves`` (default widths) on non-doubles, doubles,
  mixed, opening rolls and forced, empty and adversarial doubles positions:
  ``valid`` and ``count`` everywhere, ``boards`` at every slot (invalid
  slots included), and the port's oracle (``oracle/rules.py``) order;
* the env transcript of tests/test_env.py on the port's env and sorted
  engine against the port's oracle env;
* one merged ``rollout_step`` with ``algo="sorted"`` teacher-forced against
  JAX's with its noise and dice injected;
* the trajectory games of ``scripts/trajectory_parity.py``: the first 64
  games of the 4096-game streams through the port's script on the CPU give
  lines 0-63 of ``artifacts/traj_jax_4096.jsonl`` (64 rather than 128 keeps
  the test near 30 s on two threads).
"""
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.actor import rollout as jR
from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.engine import movegen as jMG
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as tR
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen as tMG
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from mlp_ppo_2ply_multi_tpu_torch.oracle import env as tOE
from mlp_ppo_2ply_multi_tpu_torch.oracle import rules as tRules
from mlp_ppo_2ply_multi_tpu_torch.scripts import trajectory_parity as TP
from tests.helpers import (
    bearoff_doubles_case,
    blocked_doubles_case,
    collect_no4move_doubles,
    sample_cases,
)
from tests.test_torch_rollout import CKPT, _leaves, _state_to_port, _t
from tests.test_torch_rollout_chunked import B as B_ROLL
from tests.test_torch_rollout_chunked import W as W_ROLL
from tests.test_torch_rollout_chunked import merged_cfg, small_state

ROOT = Path(__file__).resolve().parents[1]
N = 64  # the jitted JAX batch
JCFG = jcfg.MoveGenConfig(algo="sorted")
TCFG = tcfg.MoveGenConfig(algo="sorted")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The sorted engine's [N, 288, 27] level tensors want more than one
    thread; two keep parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(lambda b, p, d: jMG.legal_moves(b, p, d, JCFG))


def _np_boards(boards):
    return np.array([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards], np.int8)


def _tuple(row):
    r = [int(x) for x in row]
    return (tuple(r[0:24]), tuple(r[24:48]), tuple(r[48:50]), tuple(r[50:52]))


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("die", range(1, 7))
def test_board_hash_and_submove_deltas_bit_equal(die):
    boards, players, _ = sample_cases(40 + die, 128)
    data, pl = _np_boards(boards), np.asarray(players, np.int32)
    jb, tb = jB.Board(jnp.asarray(data)), tB.Board(torch.from_numpy(data))
    for a, b in zip(jB.board_hash(jb), tB.board_hash(tb)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    st = jMG.slot_table(jb, jnp.asarray(pl), jnp.full((128,), die, jnp.int32))
    tst = tMG.slot_table(tb, torch.from_numpy(pl), torch.full((128,), die))
    valid = np.asarray(st.valid)
    assert valid.any() and (~valid).any()
    for s in range(tMG.N_SLOTS):
        want = jB.submove_hash_delta(jb, jnp.asarray(pl), st.start[:, s], st.end[:, s],
                                     st.hits[:, s])
        got = tB.submove_hash_delta(tb, torch.from_numpy(pl), tst.start[:, s], tst.end[:, s],
                                    tst.hits[:, s])
        for a, b in zip(want, got):  # valid and invalid submoves alike
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


# ---------------------------------------------------------------------------
# dedup
# ---------------------------------------------------------------------------


def _dedup_inputs(seed, rows=8, n=300):
    """Hashes drawn from a pool of 24 pairs (heavy duplication; h1 values
    above 2^31 test the unsigned order), 40% invalid, flag ranks INF or a
    candidate index."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, (24, 2), dtype=np.uint64).astype(np.uint32)
    pool[:4, 0] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    pick = rng.integers(0, 24, (rows, n))
    h1, h2 = pool[pick, 0], pool[pick, 1]
    valid = rng.random((rows, n)) < 0.6
    flag = np.where(rng.random((rows, n)) < 0.5, np.arange(n), 0x7FFFFFFF).astype(np.int32)
    return h1, h2, valid, flag


@pytest.mark.parametrize("width", [16, 200, 512])
@pytest.mark.parametrize("with_flag", [False, True])
def test_dedup_compact_bit_equal_at_every_position(width, with_flag):
    h1, h2, valid, flag = _dedup_inputs(width + with_flag)
    survivors = max(len({(a, b) for a, b, v in zip(*r) if v}) for r in zip(h1, h2, valid))
    assert 16 < survivors < 200  # width 16 below the survivor count, 200 above
    want = jMG.dedup_compact(jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(valid), width,
                             jnp.asarray(flag) if with_flag else None)
    got = tMG.dedup_compact(torch.from_numpy(h1.astype(np.int64)),
                            torch.from_numpy(h2.astype(np.int64)), torch.from_numpy(valid),
                            width, torch.from_numpy(flag.astype(np.int64)) if with_flag else None)
    assert got[1].shape == (8, min(width, 300))
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if with_flag:
        np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    else:
        assert got[2] is None


def test_segmented_min_to_group_first_bit_equal():
    rng = np.random.default_rng(3)
    values = rng.integers(0, 2**31, (16, 400)).astype(np.int32)
    values[rng.random((16, 400)) < 0.3] = 0x7FFFFFFF
    first = rng.random((16, 400)) < 0.2
    first[0, 0] = False
    want = jMG._segmented_min_to_group_first(jnp.asarray(values), jnp.asarray(first))
    got = tMG._segmented_min_to_group_first(torch.from_numpy(values), torch.from_numpy(first))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# legal moves
# ---------------------------------------------------------------------------


def _adversarial_cases():
    """Hand-crafted forced and empty positions (JAX tests/test_movegen.py:
    112-142), blocked and bear-off doubles chains and doubles whose longest
    sequence is below 4 submoves (the forced-shorter records)."""
    p2 = [0] * 24
    p2[0:6] = [2] * 6
    p1 = [0] * 24
    p1[12] = 14
    closed = (tuple(p1), tuple(p2), (1, 0), (0, 3))
    p1b = [0] * 24
    p1b[23] = 1
    p2b = [0] * 24
    p2b[0] = 15
    bear = (tuple(p1b), tuple(p2b), (0, 0), (14, 0))
    cases = [(closed, 0, (3, 5)), (closed, 0, (2, 2)), (bear, 0, (6, 1)), (bear, 0, (4, 4))]
    rng = random.Random(11)
    for _ in range(20):
        b, p, d = blocked_doubles_case(rng)
        cases.append((b, p, (d, d)))
    for _ in range(20):
        b, p, d = bearoff_doubles_case(rng)
        cases.append((b, p, (d, d)))
    cases += [(b, p, (d, d)) for b, p, d in collect_no4move_doubles(5, N - len(cases))]
    return cases


def _opening_cases():
    start = tRules.start_board()
    return [(start, p, (d0, d1)) for d0 in range(1, 7) for d1 in range(1, 7) for p in (0, 1)]


def _case_batches(kind):
    if kind in ("nondoubles", "doubles", "mixed"):
        bias = {"nondoubles": 0.0, "doubles": 1.0, "mixed": 0.4}[kind]
        boards, players, dice = sample_cases({"nondoubles": 101, "doubles": 202,
                                              "mixed": 303}[kind], N, bias)
        cases = list(zip(boards, players, dice))
    else:
        cases = _opening_cases() if kind == "opening" else _adversarial_cases()
    while len(cases) % N:
        cases.append(cases[0])
    for s in range(0, len(cases), N):
        chunk = cases[s:s + N]
        yield ([c[0] for c in chunk], np.asarray([c[1] for c in chunk], np.int32),
               np.asarray([c[2] for c in chunk], np.int32))


@pytest.mark.parametrize("kind", ["nondoubles", "doubles", "mixed", "opening", "adversarial"])
def test_sorted_legal_moves_bit_equal_and_in_oracle_order(jitted, kind):
    seen_counts = 0
    for boards, players, dice in _case_batches(kind):
        data = _np_boards(boards)
        want = jax.tree.map(np.asarray, jitted(jB.Board(jnp.asarray(data)), jnp.asarray(players),
                                                jnp.asarray(dice)))
        got = tMG.legal_moves(tB.Board(torch.from_numpy(data)), torch.from_numpy(players),
                              torch.from_numpy(dice), TCFG)
        assert got.overflow is None and want.overflow is None
        np.testing.assert_array_equal(want.count, got.count.numpy())
        np.testing.assert_array_equal(want.valid, got.valid.numpy())
        gb = got.boards.data.numpy()
        np.testing.assert_array_equal(want.boards.data[want.valid], gb[want.valid])
        np.testing.assert_array_equal(want.boards.data, gb)  # invalid slots too
        for g in range(N):
            oracle = tRules.full_moves(boards[g], int(players[g]), list(dice[g]))
            n = min(len(oracle), TCFG.a_max)
            assert int(got.count[g]) == n, (kind, g)
            assert [_tuple(r) for r in gb[g, :n]] == [b for _, b in oracle[:n]], (kind, g)
        seen_counts += int(want.count.sum())
    assert seen_counts > 0


def test_env_transcript_with_the_sorted_engine_matches_the_oracle_env():
    """tests/test_env.py:33 on the port: 8 games, 60 steps, one injected
    dice stream and a shared deterministic policy; counts, rewards and done
    each step, boards, win types and the side to move at the end."""
    games, steps = 8, 60
    rng = np.random.default_rng(99)
    nd = tE._ND_PAIRS
    opener = nd[rng.integers(0, 30, size=games)]
    first = nd[rng.integers(0, 30, size=games)]
    dice = rng.integers(1, 7, size=(steps, games, 2)).astype(np.int32)
    cfg = tcfg.Config(movegen=TCFG)
    state = tE.reset_from_rolls(torch.from_numpy(opener), torch.from_numpy(first))
    envs = [tOE.OracleEnv(iter([tuple(opener[g]), tuple(first[g])]
                               + [tuple(d) for d in dice[:, g]])) for g in range(games)]
    for e in envs:
        e.reset()
    o_done = [False] * games
    for t in range(steps):
        counts = [0 if o_done[g] else envs[g].num_moves for g in range(games)]
        actions = [(t * 13 + 7 * g) % c if c else 0 for g, c in enumerate(counts)]
        moves = tMG.legal_moves(state.board, state.player, state.dice, cfg.movegen)
        res = tE.step(state, moves, torch.tensor(actions, dtype=torch.int32),
                      torch.from_numpy(dice[t]), cfg.env)
        for g in range(games):
            if o_done[g]:
                assert float(res.reward[g]) == 0.0
                continue
            assert int(moves.count[g]) == counts[g], (t, g)
            _, r, d, _ = envs[g].step(None if counts[g] == 0 else actions[g])
            assert np.isclose(float(res.reward[g]), r), (t, g)
            assert bool(res.done[g]) == d, (t, g)
            o_done[g] = o_done[g] or d
        state = res.state
    wt_map = {None: 0, "regular": 1, "gammon": 2, "backgammon": 3}
    for g in range(games):
        assert _tuple(state.board.data[g]) == envs[g].board, g
        assert int(state.win_type[g]) == wt_map[envs[g].win_type], g
        if not o_done[g]:
            assert int(state.player[g]) == envs[g].player


# ---------------------------------------------------------------------------
# the merged rollout step
# ---------------------------------------------------------------------------


def test_merged_rollout_step_teacher_forced_with_the_sorted_engine():
    """JAX's merged f32 rollout_step under algo "sorted" (the widths of
    tests/test_torch_rollout_chunked.py) against the port's with the same
    noise: every integer field and the state bit-equal, values at rtol
    1e-5, no overflow flagged (the sorted engine tracks none)."""
    jc = merged_cfg(jcfg, algo="sorted")
    tc = merged_cfg(tcfg, algo="sorted")
    jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    js = small_state()
    ts = _state_to_port(js)
    key = jax.random.PRNGKey(8)
    k_act, k_roll, k_reset = jax.random.split(key, 3)
    k_start, k_first = jax.random.split(k_reset)
    noise = tR.StepNoise(*(_t(x) for x in (
        jax.random.gumbel(k_act, (B_ROLL, W_ROLL)), jnp.zeros((0, W_ROLL)),
        jE.roll_dice(k_roll, (B_ROLL,)), jE.roll_nondouble(k_start, (B_ROLL,)),
        jE.roll_nondouble(k_first, (B_ROLL,)))))
    jstate, jt = jax.device_get(jax.jit(
        lambda s, k: jR.rollout_step(jparams, s, k, jnp.float32(0.7), jc, True))(js, key))
    tstate, tt = tR.rollout_step(tparams, ts, 0.7, tc, True, noise=noise, device="cpu")
    lw, lg = _leaves(jt), _leaves(tt)
    assert set(lw) == set(lg)
    for k in lw:
        if k == "value":
            np.testing.assert_allclose(lg[k], lw[k], rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)
    for k, v in _leaves(jstate).items():
        np.testing.assert_array_equal(_leaves(tstate)[k], v, err_msg=k)
    assert not lg["overflow"].any() and lg["recorded"].any() and lg["done"].any()


# ---------------------------------------------------------------------------
# the trajectory games
# ---------------------------------------------------------------------------


def test_trajectory_games_reproduce_the_jax_transcript_hashes():
    games = 64
    recs = TP.run(games, device="cpu", log=lambda *a: None)
    want = TP.load(str(ROOT / "artifacts" / "traj_jax_4096.jsonl"))
    assert [r["g"] for r in recs] == list(range(games))
    for r in recs:
        assert r == want[r["g"]], r
    result = TP.compare(want, {r["g"]: r for r in recs})
    assert result["games_compared"] == result["bit_identical"] == games
    assert result["total_steps"] == sum(want[g]["steps"] for g in range(games))
