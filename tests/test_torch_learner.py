"""The port's TD(0) learner against the JAX package's, on the CPU.

The same seeded numpy trajectories go through ``mlp_ppo_2ply_multi_tpu``'s
learner and ``mlp_ppo_2ply_multi_tpu_torch``'s, from the same state (a JAX
state after one JAX update, so the Adam moments are not zero, carried over
by ``train_state_from_jax``). Tolerances: the port computes the same f32
functions in another summation order (matmuls, reductions), so losses,
norms and metric means agree at rtol 1e-5, params at atol 1e-6, the Adam
moments at rtol 1e-4 (with an absolute floor of 1e-6 of the tensor's
largest moment: an element that is a near-cancelling sum of many gradient
terms, ~1e-3 of its neighbours, carries their absolute rounding error, not
its own), and counters exactly. Where the arithmetic is
elementwise and the sums are exact (the clip on dyadic gradients), the port
equals optax at rtol 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.actor.rollout import Transition as JTransition
from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.learner import td as jtd
from mlp_ppo_2ply_multi_tpu_torch.actor.rollout import Transition as TTransition
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.learner import td as ttd
from tests.helpers import sample_cases

TD_MODES = ["reference", "negamax", "side0"]
FLOAT_METRICS = ("loss", "grad_norm", "td_abs", "v_mean", "reward_per_episode",
                 "episode_length")
INT_METRICS = ("wins_regular", "wins_gammon", "wins_backgammon", "close_out_count",
               "prime_count", "width_overflow_count")


def np_traj(seed, T, B):
    """A [T, B] trajectory with sampled boards and plausible flags: passes,
    wins of every type, truncations, shaping bonuses, width overflows."""
    rng = np.random.default_rng(seed)
    boards, _, _ = sample_cases(seed, T * B)
    data = np.array(
        [list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards], np.int8
    ).reshape(T, B, 52)
    rec = rng.random((T, B)) < 0.8
    boundary = rng.random((T, B)) < 0.1
    done = boundary & rec & (rng.random((T, B)) < 0.7)
    win_type = np.where(done, rng.integers(1, 4, (T, B)), 0).astype(np.int8)
    reward = np.where(done, np.array([0.0, 1.0, 2.0, 2.5])[win_type], 0.0)
    close_out = rec & ~done & (rng.random((T, B)) < 0.05)
    prime = rec & ~done & (rng.random((T, B)) < 0.05)
    reward = (reward + 0.3 * close_out + 0.2 * prime).astype(np.float32)
    return dict(
        packed_board=data,
        player=rng.integers(0, 2, (T, B)).astype(np.int32),
        reward=reward,
        recorded=rec,
        done=done,
        boundary=boundary,
        value=np.zeros((T, B), np.float32),
        win_type=win_type,
        close_out=close_out,
        prime=prime,
        num_moves=rng.integers(0, 30, (T, B)).astype(np.int32),
        overflow=rec & (rng.random((T, B)) < 0.05),
    )


def jax_traj(d):
    return JTransition(**{k: jnp.asarray(v) for k, v in d.items()})


def port_traj(d):
    return TTransition(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def configs(td_mode, per_episode, batch):
    return [
        mod.Config(train=mod.TrainConfig(
            td_mode=td_mode, per_episode_updates=per_episode, batch_games=batch))
        for mod in (jcfg, tcfg)
    ]


def assert_states_close(js, ts):
    """Params at atol 1e-6, Adam moments at rtol 1e-4, counters equal."""
    js = jax.device_get(js)
    adam = js.opt_state[1][0]
    for k in js.params:
        np.testing.assert_allclose(ts.params[k].numpy(), js.params[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        for name, want in (("mu", adam.mu[k]), ("nu", adam.nu[k])):
            got = getattr(ts.opt_state, name)[k].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{name} {k}")
    assert int(ts.opt_state.count) == int(adam.count)
    assert int(ts.version) == int(js.version)
    assert int(ts.episode_count) == int(js.episode_count)


def assert_metrics_close(jm, tm):
    jm = jax.device_get(jm)
    assert set(jm) == set(tm)
    for k in FLOAT_METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for k in INT_METRICS:
        assert int(tm[k]) == int(jm[k]), k
    assert any(int(tm[k]) > 0 for k in INT_METRICS)


def updates_from_a_trained_state(td_mode, per_episode, T, B, seed):
    """One JAX update from init (non-zero moments), that state carried to
    the port, then the same second trajectory through both updates."""
    jc, tc = configs(td_mode, per_episode, B)
    js = jtd.init_train_state(jax.random.PRNGKey(seed), jc)
    js, _ = jtd.update(js, jax_traj(np_traj(seed, T, B)), jc)
    ts = ttd.train_state_from_jax(jax.device_get(js), "cpu")
    assert_states_close(js, ts)
    second = np_traj(seed + 1, T, B)
    js2, jm = jtd.update(js, jax_traj(second), jc)
    ts2, tm = ttd.update(ts, port_traj(second), tc, "cpu")
    return js2, jm, ts2, tm


@pytest.mark.parametrize("td_mode", TD_MODES)
def test_episode_targets_match_jax(td_mode):
    rng = np.random.default_rng(3)
    T, B = 40, 16
    v = rng.normal(size=(T, B)).astype(np.float32)
    r = (rng.random((T, B)) * (rng.random((T, B)) < 0.3)).astype(np.float32)
    rec = rng.random((T, B)) < 0.7
    bnd = rng.random((T, B)) < 0.1
    pl = rng.integers(0, 2, (T, B)).astype(np.int32)
    want = jtd._episode_targets(
        jnp.asarray(v), jnp.asarray(r), jnp.asarray(rec), jnp.asarray(bnd), 0.99,
        td_mode=td_mode, player=jnp.asarray(pl),
    )
    got = ttd._episode_targets(
        *(torch.from_numpy(x) for x in (v, r, rec, bnd)), 0.99, td_mode=td_mode,
        player=torch.from_numpy(pl),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("td_mode", TD_MODES)
def test_episode_loss_and_gradients_match_jax(td_mode):
    """One episode column through both packages' loss: loss, td_abs, v_mean
    and the gradient of every param."""
    jc, tc = configs(td_mode, False, 4)
    d = np_traj(9, 20, 4)
    jparams = jtd.init_train_state(jax.random.PRNGKey(1), jc).params
    obs = jtd.encode_traj(jax_traj(d), jc)[:, 2]
    cols = [jnp.asarray(d[k][:, 2]) for k in ("reward", "recorded", "boundary", "player")]
    (jloss, jaux), jgrads = jax.value_and_grad(jtd.episode_loss_and_metrics, has_aux=True)(
        jparams, obs, *cols[:3], jc, cols[3])
    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jparams.items()}
    tcols = [torch.from_numpy(np.array(c)) for c in cols]
    tloss, taux = ttd.episode_loss_and_metrics(
        tparams, torch.from_numpy(np.array(obs)), *tcols[:3], tc, tcols[3])
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for k in ("td_abs", "v_mean"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    for k, g in jgrads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(tparams[k].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max(), err_msg=k)


def test_temperature_matches_jax():
    jc, tc = configs("reference", False, 8)
    for version in (0, 1, 2000, 3999, 4000, 9999):
        want = float(jtd.temperature(jnp.int32(version), jc))
        assert abs(float(ttd.temperature(torch.tensor(version), tc)) - want) <= 1e-7


@pytest.mark.parametrize("td_mode", TD_MODES)
def test_fused_update_matches_jax(td_mode):
    js2, jm, ts2, tm = updates_from_a_trained_state(td_mode, False, T=12, B=16, seed=5)
    assert_metrics_close(jm, tm)
    assert_states_close(js2, ts2)


@pytest.mark.parametrize("td_mode", TD_MODES)
def test_per_episode_update_matches_jax(td_mode):
    """Q2: one Adam step per episode column, at T = 6, B = 3."""
    js2, jm, ts2, tm = updates_from_a_trained_state(td_mode, True, T=6, B=3, seed=7)
    assert_metrics_close(jm, tm)
    assert_states_close(js2, ts2)
    assert int(ts2.opt_state.count) == 6 and int(ts2.version) == 2


def dyadic_grads(norm_sq_target, seed):
    """Gradients on a 2^-11 grid whose sums of squares are exact in f32 in
    any order (so both packages get the same norm), with the global norm
    close to sqrt(norm_sq_target)."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (198, 128), "b1": (128,), "w2": (128, 1), "b2": (1,)}
    g = {k: rng.integers(-2, 3, s).astype(np.float32) * 2.0**-11 for k, s in shapes.items()}
    rest = sum(float(np.sum(v.astype(np.float64) ** 2)) for k, v in g.items() if k != "b2")
    g["b2"][0] = np.round(np.sqrt(norm_sq_target - rest) * 2**11) * 2.0**-11
    return g


@pytest.mark.parametrize("side", ["above", "below"])
def test_clip_matches_optax(side):
    g = dyadic_grads(1.001**2 if side == "above" else 0.999**2, seed=11)
    norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in g.values()))
    assert (norm > 1.0) == (side == "above") and abs(norm - 1.0) < 2e-3
    clip = optax.clip_by_global_norm(1.0)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    want, _ = clip.update(jg, clip.init(jg))
    got, tnorm = ttd.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    assert float(tnorm) == float(optax.global_norm(jg))
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-7, err_msg=k)
        assert np.array_equal(got[k].numpy(), g[k]) == (side == "below")


def test_lr_decay_steps_match_optax():
    """Three steps with lr_decay=0.5, lr_decay_steps=1 (the staircase
    schedule), equal to optax's chain; the later steps shrink."""
    cfgs = [mod.Config(train=mod.TrainConfig(lr_decay=0.5, lr_decay_steps=1))
            for mod in (jcfg, tcfg)]
    opt = jtd.make_optimizer(cfgs[0])
    jp = {"w": jnp.ones((4,))}
    jst = opt.init(jp)
    tp = {"w": torch.ones(4)}
    adam = ttd.init_adam(tp)
    moves = []
    for i in range(3):
        g = np.full((4,), 0.25 + 0.125 * i, np.float32)
        up, jst = opt.update({"w": jnp.asarray(g)}, jst, jp)
        jp = optax.apply_updates(jp, up)
        before = tp["w"].clone()
        adam, _ = ttd.apply_gradients(tp, {"w": torch.from_numpy(g)}, adam, cfgs[1])
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), atol=1e-7)
        moves.append(float((before - tp["w"]).abs().sum()))
    assert moves[2] < 0.6 * moves[1] < 0.6 * moves[0]


def test_pack_metrics_keeps_counters_exact():
    """The port packs into float64: a counter of 2^24 + 1 comes back exact
    (the JAX package's float32 vector rounds it to 2^24)."""
    big = 2**24 + 1
    names, vec = ttd.pack_metrics({"loss": torch.tensor(0.5), "count": torch.tensor(big)})
    assert vec.dtype == torch.float64 and names == ("count", "loss")
    assert dict(zip(names, vec.tolist())) == {"count": big, "loss": 0.5}
    jnames, jvec = jtd.pack_metrics({"loss": jnp.float32(0.5), "count": jnp.int32(big)})
    assert dict(zip(jnames, np.asarray(jvec).tolist()))["count"] == 2**24


def test_update_params_change_in_place_and_counters_stay_on_device():
    _, tc = configs("side0", False, 8)
    state = ttd.init_train_state(tc, torch.Generator().manual_seed(0), "cpu")
    w1 = state.params["w1"]
    v0 = w1._version
    new, metrics = ttd.update(state, port_traj(np_traj(1, 5, 8)), tc, "cpu")
    assert new.params["w1"] is w1 and w1._version > v0
    assert not any(p.requires_grad for p in new.params.values())
    assert new.version.dtype == torch.int64 and new.version.dim() == 0
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
