"""The port's arena (``eval.arena``) against the JAX package's, on the CPU,
on the f32 value path at the reduced widths of the engine tests.

* The four policies take JAX's actions on the same states, legal moves and
  noise. The noise ``jax.random.categorical`` adds is derived from the JAX
  key and injected into the port. The 2-ply policy's JAX side runs in a
  spawned interpreter (a second lowering of JAX's 2-ply scorer in one
  process fails with JAX 0.9 on the CPU; see ROADMAP's constraints).
* Two matches, teacher-forced: each step of the port starts from the JAX
  state (numpy dice and noise), and its next state and actions equal JAX's;
  the port's free-running ``play_match`` gives JAX's winner, win_type and
  steps bit-equal.
* The port's eager chunked match equals its step-by-step loop, and
  ``summarize`` equals JAX's.

Integer results are bit-exact; no decision may differ (f32 values from the
same function; the test fails rather than excuse a near-tie).
"""
import functools
import multiprocessing
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.engine import movegen as jMG
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.eval import arena as jA
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine.movegen import MoveSet as tMoveSet
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.eval import arena as tA
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from tests.helpers import sample_cases

CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
# the reduced widths of tests/test_split_planes.py, with the evaluate
# CLI's single-pass non-doubles tail (nd_tier 0)
SMALL = dict(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, dd_subbatch_div=3)
B = 24
STEPS = 60
TEMP = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(mod, td_mode):
    return mod.Config(
        movegen=mod.MoveGenConfig(**SMALL),
        train=mod.TrainConfig(td_mode=td_mode),
        twoply=mod.TwoPlyConfig(
            enabled=True, reply_a_max=32,
            dd_reply_widths=((16, 32, 32, 32),) * 3 + ((16, 32, 48, 48),) * 3,
        ),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def start_state(seed, n):
    """Sampled mid-game, bar and bear-off positions, so games finish."""
    boards, players, dice = sample_cases(seed, n, 0.2)
    data = np.array(
        [list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards], np.int8
    )
    return jE.EnvState(
        board=jB.Board(jnp.asarray(data)),
        player=jnp.asarray(np.asarray(players, np.int32)),
        dice=jnp.asarray(np.asarray(dice, np.int32)),
        game_over=jnp.zeros(n, bool),
        win_type=jnp.zeros(n, jnp.int8),
        close_out_given=jnp.zeros((n, 2), bool),
        prime_given=jnp.zeros((n, 2), bool),
        step_count=jnp.zeros(n, jnp.int32),
    )


def state_to_port(js) -> tE.EnvState:
    js = jax.device_get(js)
    return tE.EnvState(
        board=tB.Board(_t(js.board.data)),
        **{k: _t(getattr(js, k)) for k in jE.EnvState._fields if k != "board"},
    )


def moves_to_port(jm) -> tMoveSet:
    jm = jax.device_get(jm)
    return tMoveSet(tB.Board(_t(jm.boards.data)), _t(jm.valid), _t(jm.count), _t(jm.overflow))


def params():
    jp = jV.load_torch_checkpoint(CKPT)
    return jp, tV.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


POLICIES = {
    "greedy": lambda m, c: m.greedy_policy(c),
    "softmax": lambda m, c: m.softmax_policy(c, TEMP),
    "random": lambda m, c: m.random_policy(c),
    "twoply": lambda m, c: m.twoply_greedy_policy(c),
}


ONE_PLY = [(name, td) for name in ("greedy", "softmax", "random")
           for td in ("reference", "side0")]


@functools.partial(jax.jit, static_argnames=("cases",))
def _jax_acts(jparams, st, key, cases):
    """Each case's (policy name, td_mode) actions on one batch of states,
    with its legal moves (the config's movegen is the same for all)."""
    cfgs = [make_cfg(jcfg, td) for _, td in cases]
    moves = jMG.legal_moves(st.board, st.player, st.dice, cfgs[0].movegen)
    acts = [POLICIES[name](jA, c)(jparams, st, moves, key) for (name, _), c in zip(cases, cfgs)]
    return moves, acts


def jax_policy_actions(cases, seed, n):
    """JAX's actions of the policies ``cases`` on sampled states: (state,
    moves, noise, {case: actions}) as numpy. The noise is the Gumbel draw
    ``categorical`` makes from the key."""
    jax.config.update("jax_platforms", "cpu")
    jp, _ = params()
    st = start_state(seed, n)
    key = jax.random.PRNGKey(seed)
    moves, acts = _jax_acts(jp, st, key, tuple(cases))
    noise = jax.random.gumbel(key, moves.valid.shape)
    return jax.device_get((st, moves, noise, dict(zip(cases, acts))))


def port_actions(name, td_mode, st, moves, noise):
    _, tp = params()
    policy = POLICIES[name](tA, make_cfg(tcfg, td_mode))
    return policy(tp, state_to_port(st), moves_to_port(moves), _t(noise)).numpy()


@pytest.fixture(scope="module")
def one_ply_run():
    return jax_policy_actions(ONE_PLY, 3, 48)


@pytest.mark.parametrize("name,td_mode", ONE_PLY)
def test_policy_actions_match_jax(name, td_mode, one_ply_run):
    st, moves, noise, want = one_ply_run
    got = port_actions(name, td_mode, st, moves, noise)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(want[name, td_mode]))
    assert len(set(got.tolist())) > 3  # not all rows took slot 0


def test_twoply_policy_actions_match_jax():
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        st, moves, noise, want = pool.apply_async(
            jax_policy_actions, ([("twoply", "side0")], 7, 16)
        ).get(timeout=900)
    want = want["twoply", "side0"]
    got = port_actions("twoply", "side0", st, moves, noise)
    np.testing.assert_array_equal(got, np.asarray(want))
    greedy = port_actions("greedy", "side0", st, moves, noise)
    counts = np.asarray(moves.count)
    assert (counts >= 4).sum() > 8
    assert (got != greedy).any()  # the rerank changed some decisions


# ---------------------------------------------------------------------------
# matches
# ---------------------------------------------------------------------------


MATCHES = (("greedy", "greedy", "side0"), ("softmax", "random", "reference"))


@jax.jit
def jax_match_steps(jparams, sts, wins, keys, dice):
    """One step of each of ``MATCHES``, as the body of JAX's ``play_match``
    (arena.py:112-127): JAX ``legal_moves``, both policies with their keys,
    the per-side select, ``vec_env.step`` with the injected dice and the
    winner latch."""
    out = []
    for (na, nb, td), st, win, (k_a, k_b), d in zip(MATCHES, sts, wins, keys, dice):
        cfg = make_cfg(jcfg, td)
        moves = jMG.legal_moves(st.board, st.player, st.dice, cfg.movegen)
        a_act = POLICIES[na](jA, cfg)(jparams, st, moves, k_a)
        b_act = POLICIES[nb](jA, cfg)(jparams, st, moves, k_b)
        action = jnp.where(st.player == 0, a_act, b_act)
        res = jE.step(st, moves, action, d, cfg.env)
        out.append((res.state, jnp.where(res.done & (win < 0), st.player, win)))
    return out


def jax_matches(seed, n, steps):
    """The JAX side of ``MATCHES`` from sampled positions: per step (states
    and winners before it, each match's noise (side A's and side B's Gumbel
    draws from their keys, the numpy dice), states and winners after it),
    as numpy."""
    jax.config.update("jax_platforms", "cpu")
    jp, _ = params()
    w = max(SMALL["a_max"], SMALL["nd_dedup_k"])
    sts = [start_state(seed, n) for _ in MATCHES]
    wins = [jnp.full((n,), -1, jnp.int32) for _ in MATCHES]
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        key, *ks = jax.random.split(key, 1 + 2 * len(MATCHES))
        keys = [(ks[2 * i], ks[2 * i + 1]) for i in range(len(MATCHES))]
        dice = [rng.integers(1, 7, (n, 2)).astype(np.int32) for _ in MATCHES]
        new = jax_match_steps(jp, sts, wins, keys, dice)
        noise = [(jax.random.gumbel(ka, (n, w)), jax.random.gumbel(kb, (n, w)), d)
                 for (ka, kb), d in zip(keys, dice)]
        out.append(jax.device_get((sts, wins, noise, new)))
        sts, wins = [s for s, _ in new], [x for _, x in new]
    return out


@pytest.fixture(scope="module")
def match_run():
    """The JAX side runs in a fresh interpreter: this file already lowers
    JAX programs, and a second lowering in one process can give a program
    that expects other inputs (JAX 0.9, CPU)."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        return pool.apply_async(jax_matches, (11, B, STEPS)).get(timeout=900)


def _leaves(x):
    out = {}
    for k in x._fields:
        v = getattr(x, k)
        if hasattr(v, "_fields"):
            out.update({f"{k}.{k2}": v2 for k2, v2 in _leaves(v).items()})
        else:
            out[k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.mark.parametrize("which", range(len(MATCHES)), ids=[f"{a}-vs-{b}" for a, b, _ in MATCHES])
def test_teacher_forced_match_matches_jax(which, match_run):
    na, nb, td_mode = MATCHES[which]
    _, tp = params()
    tc = make_cfg(tcfg, td_mode)
    tpa, tpb = POLICIES[na](tA, tc), POLICIES[nb](tA, tc)
    for i, (sts, wins, noise, new) in enumerate(match_run):
        m = tA._Match(state_to_port(sts[which]), _t(wins[which]))
        nz = tA.MatchNoise(*map(_t, noise[which]))
        got = tA.match_step(tp, tp, tpa, tpb, tc, m, nz)
        jnew, jwin = new[which]
        lj, lt = _leaves(jnew), _leaves(got.state)
        for k in lj:
            np.testing.assert_array_equal(lt[k], lj[k], err_msg=f"step {i} {k}")
        np.testing.assert_array_equal(got.winner.numpy(), jwin, err_msg=f"step {i}")
    jnew, jwin = match_run[-1][3][which]
    assert (jwin >= 0).sum() >= B // 3  # games finished
    assert (jwin == 0).any() and (jwin == 1).any()
    # free-running from the same start, with the same noise
    res = tA.play_match(
        tp, tp, tpa, tpb, None, tc, B, STEPS, device="cpu", chunk=4,
        noise=[tA.MatchNoise(*map(_t, step[2][which])) for step in match_run],
        start=state_to_port(match_run[0][0][which]))
    np.testing.assert_array_equal(res.winner.numpy(), jwin)
    np.testing.assert_array_equal(res.win_type.numpy(), jnew.win_type)
    np.testing.assert_array_equal(res.steps.numpy(), jnew.step_count)
    assert res.winner.dtype == torch.int32 and res.win_type.dtype == torch.int8


def test_chunked_match_equals_step_loop():
    """``play_match`` from a generator, in eager chunks of 5, against the
    same generator's draws fed to ``match_step`` one step at a time."""
    _, tp = params()
    tc = make_cfg(tcfg, "side0")
    pa, pb = tA.softmax_policy(tc, TEMP), tA.greedy_policy(tc)
    steps = 40
    res = tA.play_match(tp, tp, pa, pb, torch.Generator().manual_seed(3), tc, 16, steps,
                        device="cpu", chunk=5)
    gen = torch.Generator().manual_seed(3)
    cpu = torch.device("cpu")
    m = tA._Match(tE.reset(16, gen, device="cpu"), torch.full((16,), -1, dtype=torch.int32))
    for _ in range(steps):
        m = tA.match_step(tp, tp, pa, pb, tc, m, tA.draw_match_noise(16, tc, gen, cpu))
    assert torch.equal(res.winner, m.winner)
    assert torch.equal(res.win_type, m.state.win_type)
    assert torch.equal(res.steps, m.state.step_count)
    assert bool(tB.checker_conservation_ok(m.state.board).all())
    # 40 steps in chunks of at most 16: the largest divisor is 10
    res10 = tA.play_match(tp, tp, pa, pb, torch.Generator().manual_seed(3), tc, 16, steps,
                          device="cpu")
    assert torch.equal(res10.winner, res.winner)


def test_play_match_checks_its_arguments():
    _, tp = params()
    tc = make_cfg(tcfg, "reference")
    pol = tA.random_policy(tc)
    with pytest.raises(ValueError):
        tA.play_match(tp, tp, pol, pol, None, tc, 4, 0, device="cpu")
    with pytest.raises(ValueError):
        tA.play_match(tp, tp, pol, pol, None, tc, 4, 3, device="cpu", noise=[])
    with pytest.raises(ValueError):  # params on another device than asked
        tA.play_match(tp, tp, pol, pol, None, tc, 4, 3, device="meta")


def test_summarize_matches_jax():
    rng = np.random.default_rng(0)
    winner = rng.integers(-1, 2, 200).astype(np.int32)
    win_type = np.where(winner >= 0, rng.integers(1, 4, 200), 0).astype(np.int8)
    steps = rng.integers(0, 400, 200).astype(np.int32)
    want = jA.summarize(jA.MatchResult(jnp.asarray(winner), jnp.asarray(win_type),
                                       jnp.asarray(steps)))
    got = tA.summarize(tA.MatchResult(_t(winner), _t(win_type), _t(steps)))
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    none = tA.summarize(tA.MatchResult(*(_t(np.full(4, -1, np.int32)),) * 3))
    assert none["finished"] == 0 and none["win_rate_a"] == 0.0
