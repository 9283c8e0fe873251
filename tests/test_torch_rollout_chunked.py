"""The port's chunked and scanned rollouts (``rollout_chunked``,
``rollout``), the device constants and launch accounting that make the step
capturable as a CUDA graph, and the move generator's engine dispatch.

* Against JAX: ``rollout_chunked`` (8 steps, chunk 4, the merged f32
  actor) with the noise JAX's ``rollout_chunked`` draws injected: integer
  fields bit-equal, values at rtol 1e-5, the [T, B] order and the resets
  across the chunk boundary included.
* Against the eager loop: on the CPU the chunks run eagerly, and on one
  generator seed they give ``rollout_loop``'s trajectory exactly, for each
  branch of the step (split planes, merged, 2-ply), chunk 1 and 4,
  continuous and sync, and a step count that 4 does not divide.
* The cached device constants equal their numpy tables and are made once
  per device; the graph's launch accounting adds captured x replays (with
  stubs: no graph runs on the CPU); ``algo="sorted"`` runs everywhere but
  in ``legal_moves_split``.

The graphs themselves run on the card: tests/test_torch_graph_gpu.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.actor import rollout as jR
from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as tR
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.core import tree
from mlp_ppo_2ply_multi_tpu_torch.core.device import device_constant
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen as tMG
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2 as tMG2
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from mlp_ppo_2ply_multi_tpu_torch.ops import _cuda_build
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv
from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax as tX
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling
from tests.test_torch_rollout import CKPT, _leaves, _midgame_state, _state_to_port, _t
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

B = 16
STEPS, CHUNK = 8, 4
# tests/test_split_planes.py:25-35
WIDTHS = dict(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, nd_tier=16,
              nd_wide_div=4, dd_subbatch_div=3)
W = 64  # max(a_max, nd_dedup_k)
# rows of tests/test_torch_rollout.py's mid-game state: bear-offs that win
# at once, five-primes, closed boards and random positions
ROWS = np.r_[0:4, 8:12, 16:20, 24:28]
# the last four games reach the 300-step cap after 1..4 steps: the game at
# 296 truncates on step 3, the last of the first chunk
STEP_COUNTS = [299, 298, 297, 296]


def merged_cfg(mod, **movegen):
    return mod.Config(
        movegen=mod.MoveGenConfig(**{**WIDTHS, **movegen}),
        train=mod.TrainConfig(td_mode="side0"),
    )


def split_cfg(mod=tcfg):
    return mod.Config(
        movegen=mod.MoveGenConfig(**WIDTHS, split_planes=True),
        model=mod.ModelConfig(fused_actor_kernel=True, actor_tier_width=16,
                              actor_tier_wide_div=4, dtype="bfloat16"),
        train=mod.TrainConfig(td_mode="side0"),
    )


def twoply_cfg():
    base = merged_cfg(tcfg)
    return base.replace(twoply=dataclasses.replace(base.twoply, enabled=True, reply_a_max=16))


def small_state():
    js = jax.tree.map(lambda x: x[ROWS], _midgame_state(3))
    sc = np.asarray(js.step_count).copy()
    sc[-4:] = STEP_COUNTS
    return js._replace(step_count=jnp.asarray(sc))


def jax_chunk_noise(key, chunk):
    """The noise of one JAX chunk: its scan keys are ``split(sub, chunk)``,
    each split as ``rollout_step`` splits it (tests/test_torch_rollout.py,
    the merged f32 draws of tests/test_torch_train.py)."""
    out = []
    for k in jax.random.split(key, chunk):
        k_act, k_roll, k_reset = jax.random.split(k, 3)
        k_start, k_first = jax.random.split(k_reset)
        out.append(tR.StepNoise(*(_t(x) for x in (
            jax.random.gumbel(k_act, (B, W)), jnp.zeros((0, W)), jE.roll_dice(k_roll, (B,)),
            jE.roll_nondouble(k_start, (B,)), jE.roll_nondouble(k_first, (B,))))))
    return out


def test_rollout_chunked_matches_jax():
    jc, tc = merged_cfg(jcfg), merged_cfg(tcfg)
    jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    js = small_state()
    ts = _state_to_port(js)  # before JAX donates js
    key = jax.random.PRNGKey(21)
    jstate, jtraj = jax.device_get(
        jR.rollout_chunked(jparams, js, key, jnp.float32(0.7), jc, STEPS, chunk=CHUNK))
    noise = []
    for _ in range(STEPS // CHUNK):  # the chunk keys rollout_chunked splits
        key, sub = jax.random.split(key)
        noise += jax_chunk_noise(sub, CHUNK)
    tstate, ttraj = tR.rollout_chunked(tparams, ts, 0.7, tc, STEPS,
                                       chunk=CHUNK, device="cpu", noise=noise)
    lw, lg = _leaves(jtraj), _leaves(ttraj)
    assert set(lw) == set(lg) and lg["packed_board"].shape == (STEPS, B, 52)
    for k in lw:
        if k == "value":
            np.testing.assert_allclose(lg[k], lw[k], rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)
    for k, v in _leaves(jstate).items():
        np.testing.assert_array_equal(_leaves(tstate)[k], v, err_msg=k)
    # wins reset games inside the first chunk; the game at 296 steps
    # truncates on the chunk's last step and starts afresh in the next
    assert lw["done"][0, :4].all() and lw["boundary"][CHUNK - 1, -1]
    np.testing.assert_array_equal(lg["packed_board"][CHUNK, -1], np.asarray(jB.initial_board(()).data))
    assert lg["recorded"].sum() > STEPS * B // 2


def _loop_and_chunked(cfg, rollout_fn, num_steps, chunk, continuous, batch=B):
    params = tV.init_params(cfg.model, torch.Generator().manual_seed(1), "cpu")
    runs = []
    for fn in ("loop", rollout_fn):
        gen = torch.Generator().manual_seed(9)
        st = tE.reset(batch, gen, device="cpu")
        if fn == "loop":
            runs.append(tR.rollout_loop(params, st, 1.0, cfg, num_steps, continuous, gen=gen,
                                        device="cpu"))
        elif fn == "rollout":
            runs.append(tR.rollout(params, st, 1.0, cfg, num_steps, continuous, gen=gen,
                                   device="cpu"))
        else:
            runs.append(tR.rollout_chunked(params, st, 1.0, cfg, num_steps, chunk=chunk,
                                           continuous=continuous, gen=gen, device="cpu"))
    return runs


@pytest.mark.parametrize("branch,rollout_fn,num_steps,chunk,continuous", [
    ("split", "rollout_chunked", 8, 4, True),
    ("split", "rollout_chunked", 6, 1, True),
    ("split", "rollout_chunked", 8, 4, False),
    ("split", "rollout", 8, 4, False),
    ("split", "rollout", 6, 1, False),  # 4 does not divide 6: chunk 1
    ("merged", "rollout_chunked", 4, 4, True),
    ("twoply", "rollout_chunked", 4, 2, True),
])
def test_chunked_equals_the_eager_loop(branch, rollout_fn, num_steps, chunk, continuous):
    cfg = {"split": split_cfg, "merged": lambda: merged_cfg(tcfg), "twoply": twoply_cfg}[branch]()
    (s0, t0), (s1, t1) = _loop_and_chunked(cfg, rollout_fn, num_steps, chunk, continuous)
    assert t1.packed_board.shape == (num_steps, B, 52) and bool(t1.recorded.any())
    for name, a in {**_leaves(s0), **_leaves(t0)}.items():
        b = {**_leaves(s1), **_leaves(t1)}[name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_rollout_chunked_checks_its_arguments():
    cfg = split_cfg()
    params = tV.init_params(cfg.model, device="cpu")
    st = tE.reset(B, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError):
        tR.rollout_chunked(params, st, 1.0, cfg, 6, chunk=4, device="cpu")
    with pytest.raises(ValueError):
        tR.rollout_chunked(params, st, 1.0, cfg, 4, chunk=4, device="cpu",
                           noise=[tR.draw_noise(B, cfg, None, torch.device("cpu"))])
    with pytest.raises(ValueError):  # the state is not on the device asked for
        tR.rollout_chunked(params, st, 1.0, cfg, 4, device="meta")


# ---------------------------------------------------------------------------
# device constants and launch accounting
# ---------------------------------------------------------------------------


def test_device_constants_equal_their_tables_and_are_made_once():
    cpu = torch.device("cpu")
    cases = [
        (tB.initial_cells, tB._INITIAL, torch.int8),
        (tB.home_mask, tB._HOME_MASK, torch.bool),
        (tE.nd_pairs, tE._ND_PAIRS, torch.int32),
        (tX.rolls, tX.ROLLS, torch.int64),
        (lambda d: fv.g_index(fv.HIDDEN, d), fv.g_index_map(fv.HIDDEN).numpy(), torch.int64),
    ]
    for make, table, dtype in cases:
        t = make(cpu)
        assert t.dtype == dtype and t.device == cpu
        np.testing.assert_array_equal(t.numpy(), table)
        assert make(cpu) is t and make("cpu") is t  # made once per device
    hm = tB.home_mask(cpu)
    assert hm[0, 18:].all() and hm[1, :6].all() and int(hm.sum()) == 12
    # the same name on another device is another tensor, and a table is
    # copied, not shared with its numpy array
    meta = device_constant("test.table", np.arange(3), torch.device("meta"))
    assert meta.device.type == "meta"
    t = device_constant("test.table", np.arange(3), cpu)
    assert t is not meta and t.tolist() == [0, 1, 2]


def test_pack_g_reads_the_cached_index_map():
    g = torch.randn(fv.N_REP, fv.HIDDEN).to(torch.bfloat16)
    want = g.reshape(-1)[fv.g_index_map(fv.HIDDEN)]
    assert torch.equal(fv.pack_g(g), want)
    assert sorted(fv.g_index(fv.HIDDEN, "cpu").tolist()) == list(range(fv.N_REP * fv.HIDDEN))


def test_launches_captured_in_a_graph_count_once_per_replay(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "KERNELS", [])
    a = _cuda_build.CudaKernel(tmp_path / "a.cu", lambda lib: None)
    b = _cuda_build.CudaKernel(tmp_path / "b.cu", lambda lib: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    a.count_launch()
    assert (a.launches, a.captured) == (1, 0)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    with profiling.GraphLaunches() as held:
        capturing[0] = True
        for _ in range(22):
            a.count_launch()
        for _ in range(15):
            b.count_launch()
        capturing[0] = False
    assert held.per_replay == {a: 22, b: 15}
    assert (a.launches, b.launches) == (1, 0)  # a capture runs nothing
    held.replayed()
    held.replayed(3)
    assert (a.launches, b.launches) == (1 + 4 * 22, 4 * 15)
    with profiling.GraphLaunches() as none:  # a graph without kernels
        pass
    none.replayed(5)
    assert none.per_replay == {} and (a.launches, b.launches) == (1 + 4 * 22, 4 * 15)


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_chunk_graph_replay_fills_its_buffers_and_counts(monkeypatch, tmp_path):
    """ChunkGraph.replay on stand-ins for the captured graph (CPU buffers):
    the state, temperature and noise go into the static buffers, the graph
    replays once, and each replay adds the captured launches."""
    monkeypatch.setattr(profiling, "KERNELS", [])
    k = _cuda_build.CudaKernel(tmp_path / "k.cu", lambda lib: None)
    cfg = split_cfg()
    gen = torch.Generator().manual_seed(4)
    cpu = torch.device("cpu")
    g = tR.ChunkGraph.__new__(tR.ChunkGraph)
    g.graph = _StubGraph()
    g.launches = profiling.GraphLaunches()
    g.launches.per_replay = {k: 2 * CHUNK}
    g.state = tree.tmap(torch.zeros_like, tE.reset(B, gen, device="cpu"))
    g.noise = [tree.tmap(torch.zeros_like, tR.draw_noise(B, cfg, gen, cpu)) for _ in range(CHUNK)]
    g.temp = torch.zeros(())
    state = tE.reset(B, gen, device="cpu")
    noise = [tR.draw_noise(B, cfg, gen, cpu) for _ in range(CHUNK)]
    g.replay(noise, state, 0.7)
    for a, b in zip(tree.leaves(g.state), tree.leaves(state)):
        assert torch.equal(a, b)
    for buf, nz in zip(g.noise, noise):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(buf), tree.leaves(nz)))
    assert float(g.temp) == pytest.approx(0.7)
    g.replay(noise)  # the state the last replay left, same temperature
    g.replay(noise, temperature=torch.tensor(1.5))
    assert g.graph.replays == 3 and k.launches == 3 * 2 * CHUNK
    assert float(g.temp) == 1.5


# ---------------------------------------------------------------------------
# C1: the move generator's engine
# ---------------------------------------------------------------------------


def test_sorted_engine_runs_except_in_legal_moves_split():
    """The sorted engine runs through ``movegen.legal_moves``, the merged
    rollout and the 2-ply root enumeration (the 2-ply replies call
    movegen2, canonical, as in JAX), with no overflow flagged; only
    ``legal_moves_split``, canonical-only in JAX too, raises, and with it
    the split-planes step."""
    base = split_cfg()
    params = tV.init_params(base.model, torch.Generator().manual_seed(0), device="cpu")
    st = tE.reset(B, torch.Generator().manual_seed(0), device="cpu")
    sorted_mg = dataclasses.replace(base.movegen, algo="sorted")
    ms = tMG.legal_moves(st.board, st.player, st.dice, sorted_mg)
    assert ms.overflow is None and ms.valid.shape == (B, sorted_mg.a_max)
    assert bool((ms.count > 0).all())
    with pytest.raises(NotImplementedError):
        tMG2.legal_moves_split(st.board, st.player, st.dice, sorted_mg)
    split = base.replace(movegen=sorted_mg)
    with pytest.raises(NotImplementedError):
        tR.rollout_step(params, st, 1.0, split, True, gen=torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError):
        tR.rollout_chunked(params, st, 1.0, split, 2, chunk=2, device="cpu")
    merged = base.replace(movegen=dataclasses.replace(sorted_mg, split_planes=False))
    twoply = twoply_cfg()
    twoply = twoply.replace(movegen=dataclasses.replace(twoply.movegen, algo="sorted"))
    for cfg in (merged, twoply):
        gen = torch.Generator().manual_seed(1)
        new, t = tR.rollout_step(params, st, 1.0, cfg, True, gen=gen, device="cpu")
        assert bool(t.recorded.any()) and not bool(t.overflow.any())
        assert bool(tB.checker_conservation_ok(new.board).all())
        # seeded: a step where more than B / actor_tier_wide_div games have
        # over actor_tier_width moves flags the tier overflow, as it should
        _, traj = tR.rollout_chunked(params, st, 1.0, cfg, 2, chunk=2,
                                     gen=torch.Generator().manual_seed(1), device="cpu")
        assert tuple(traj.num_moves.shape) == (2, B) and not bool(traj.overflow.any())


def test_canonical_dispatch_is_movegen2():
    cfg = merged_cfg(tcfg).movegen
    st = _state_to_port(small_state())
    got = tMG.legal_moves(st.board, st.player, st.dice, cfg)
    want = tMG2.legal_moves(st.board, st.player, st.dice, cfg)
    assert got.count.sum() > 0
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
