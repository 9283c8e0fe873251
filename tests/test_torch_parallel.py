"""The port's {data, model} mesh (``parallel/``, the mesh train CLI) against
the JAX package's ``parallel/sharding.py``.

JAX runs on conftest's 8-device CPU mesh at the reduced widths of
``tests/test_parallel.py`` (TINY); the port's ranks are spawned processes
of a gloo group with one torch thread each
(``scripts/multiprocess_distributed.spawn``). Each world size is spawned
once a module, its jobs in turn, and the tests read their results."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from mlp_ppo_2ply_multi_tpu.actor import rollout as jactor
from mlp_ppo_2ply_multi_tpu.core import config as jcfg
from mlp_ppo_2ply_multi_tpu.env import vec_env as jE
from mlp_ppo_2ply_multi_tpu.learner import td as jtd
from mlp_ppo_2ply_multi_tpu.parallel import sharding as jS
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as tR
from mlp_ppo_2ply_multi_tpu_torch.apps import train
from mlp_ppo_2ply_multi_tpu_torch.core import config as tcfg
from mlp_ppo_2ply_multi_tpu_torch.core.config import ModelConfig
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env as tE
from mlp_ppo_2ply_multi_tpu_torch.learner import td as ttd
from mlp_ppo_2ply_multi_tpu_torch.parallel import sharding
from mlp_ppo_2ply_multi_tpu_torch.scripts import multiprocess_distributed as md

B = 16
STEPS = 8
JTINY = jcfg.Config(
    movegen=jcfg.MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64),
    train=jcfg.TrainConfig(batch_games=B, per_episode_updates=False),
)
TTINY = md.small_config(B)
JAX_MESHES = [(2, 1), (4, 1), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tp_grad_norm(state, traj, mesh):
    """The grad norm JAX's ``local_step`` reports under tp
    (sharding.py:140-160): pmean over "data", then the root of the psum of
    the shards' squared norms over "model"."""
    lcfg = jS._tp_config(JTINY, True)

    def local(state, traj):
        obs = jtd.encode_traj(traj, lcfg)
        grad_fn = jax.value_and_grad(jtd.episode_loss_and_metrics, has_aux=True)
        _, grads = grad_fn(state.params, obs, traj.reward, traj.recorded, traj.boundary,
                           lcfg, traj.player)
        grads = jax.lax.pmean(grads, "data")
        return jnp.sqrt(jax.lax.psum(optax.global_norm(grads) ** 2, "model"))

    specs = jS.train_state_specs(jax.eval_shape(lambda s: s, state), True)
    fn = shard_map(local, mesh=mesh, in_specs=(specs, P(None, "data")), out_specs=P(),
                   check_vma=False)
    return jax.jit(fn)(state, traj)


@pytest.fixture(scope="module")
def jax_case():
    """One JAX-rolled TINY trajectory from a fresh state, and JAX's updates
    on it: the one-device ``td.update`` and ``make_update_step`` at each
    mesh of JAX_MESHES (its tp grad norm too), fetched to numpy."""
    key = jax.random.PRNGKey(3)
    state = jtd.init_train_state(key, JTINY)
    env = jE.reset(jax.random.fold_in(key, 1), B)
    temp = jtd.temperature(state.version, JTINY)
    _, traj = jactor.rollout(state.params, env, jax.random.PRNGKey(11), temp, JTINY, 6,
                             continuous=True)
    _, m_one = jtd.update(state, traj, JTINY)
    out = {}
    for data, model in JAX_MESHES:
        mesh = jS.make_mesh(data, model, devices=jax.devices()[:data * model])
        tp = model > 1
        sh_traj = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P(None, "data"))), traj)
        new, loss = jS.make_update_step(mesh, JTINY, tp=tp)(
            jS.shard_train_state(state, mesh, tp), sh_traj)
        out[(data, model)] = dict(state=jax.device_get(new), loss=float(loss))
        if tp:
            out[(data, model)]["grad_norm"] = float(_jax_tp_grad_norm(
                jS.shard_train_state(state, mesh, tp), sh_traj, mesh))
    traj = jax.device_get(traj)
    return dict(
        state=ttd.train_state_from_jax(jax.device_get(state), "cpu"),
        traj=tR.Transition(*(torch.from_numpy(np.array(getattr(traj, f)))
                             for f in tR.Transition._fields)),
        grad_norm=float(m_one["grad_norm"]), updates=out,
    )


def _train_job(**kw):
    return {**dict(cfg=TTINY, batch=B, steps=STEPS, updates=2, seed=0, noise=True), **kw}


@pytest.fixture(scope="module")
def world2(jax_case, tmp_path_factory):
    """Two ranks: make_update_step at (2, 1) on JAX's trajectory, the
    train step at (2, 1) on injected noise, the tp forward at (1, 2), and
    the CLI with --data 2; and the one-rank control of the train step."""
    d = tmp_path_factory.mktemp("cli_data2")
    gen = torch.Generator().manual_seed(5)
    fwd = dict(cfg=TTINY, params=jax_case["state"].params,
               x=torch.rand((3, 7, 198), generator=gen))
    argv = ["--device", "cpu", "--data", "2", "--small-movegen", "--batch-games", "8",
            "--steps-per-update", "4", "--updates", "2", "--log-every", "1",
            "--checkpoint-dir", str(d / "ck"), "--metrics-dir", str(d / "runs")]
    ranks = md.spawn(2, [
        (md.job_update, dict(cfg=TTINY, state=jax_case["state"], traj=jax_case["traj"],
                             meshes=[(2, 1)])),
        (md.job_train, _train_job(data=2, model=1)),
        (md.job_forward, fwd),
        (md.job_cli, dict(argv=argv)),
    ], "cpu")
    ((control,),) = md.spawn(1, [(md.job_train, _train_job(data=1, model=1))], "cpu")
    return dict(ranks=ranks, control=control, cli_dir=d)


@pytest.fixture(scope="module")
def world4(jax_case):
    """Four ranks: make_update_step at (4, 1) and (2, 2) on JAX's
    trajectory, and the tp train step at (2, 2) with each data index's
    own generator."""
    return md.spawn(4, [
        (md.job_update, dict(cfg=TTINY, state=jax_case["state"], traj=jax_case["traj"],
                             meshes=[(4, 1), (2, 2)])),
        (md.job_train, _train_job(data=2, model=2, noise=False, updates=1)),
    ], "cpu")


def _port_update(world2, world4, data, model):
    if (data, model) == (2, 1):
        return [r[0][0] for r in world2["ranks"]]
    return [r[0][[(4, 1), (2, 2)].index((data, model))] for r in world4]


def test_configs_match_jax_tiny():
    assert tcfg.Config(movegen=tcfg.MoveGenConfig(**{
        f: getattr(JTINY.movegen, f) for f in ("w1", "w2", "w3", "w4", "a_max")}),
        train=tcfg.TrainConfig(batch_games=B, per_episode_updates=False)) == TTINY
    assert sharding._tp_config(TTINY, True).model.model_axis == "model"
    assert not sharding._tp_config(TTINY.replace(
        train=tcfg.TrainConfig(per_episode_updates=True)), False).train.per_episode_updates


def test_tp_forward_equals_the_full_forward(world2):
    """Each rank's hidden-layer shard, all-reduced over "model", gives the
    unsharded value: rtol 1e-6, atol 1e-6 of the largest value (the split
    changes the head's summation order, which matters near 0)."""
    for r in world2["ranks"]:
        out = r[2]
        full = out["full"].numpy()
        np.testing.assert_allclose(out["tp"].numpy(), full, rtol=1e-6,
                                   atol=1e-6 * np.abs(full).max())
    assert torch.equal(world2["ranks"][0][2]["tp"], world2["ranks"][1][2]["tp"])


@pytest.mark.parametrize("data,model", [(2, 1), (4, 1)])
def test_data_parallel_update_step_matches_jax(jax_case, world2, world4, data, model):
    """make_update_step against JAX's on one JAX-rolled trajectory: loss at
    rtol 1e-6, params at rtol 1e-5 / atol 1e-6 (JAX's own DP test), Adam's
    moments at rtol 1e-5, counters equal, and the grad norm at rtol 1e-5
    against JAX's one-device update (the mean gradient is the global one)."""
    want = jax_case["updates"][(data, model)]
    ranks = _port_update(world2, world4, data, model)
    got = ranks[0]
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=1e-6, atol=1e-7)
    md.assert_state_close(got["state"], ttd.train_state_from_jax(want["state"], "cpu"),
                          f"({data}, {model}) vs JAX")
    np.testing.assert_allclose(got["metrics"]["grad_norm"], jax_case["grad_norm"], rtol=1e-5)
    for r in ranks[1:]:
        for k, v in got["state"].params.items():
            assert torch.equal(r["state"].params[k], v), k


def test_tensor_parallel_update_step_matches_jax(jax_case, world4):
    """(2, 2) against JAX's ``make_mesh(2, 2, devices=jax.devices()[:4])``:
    loss, params, Adam's mu and nu and the reported grad norm at rtol 1e-5.
    The moments carry JAX's psum-transpose scale (2x for w1, b1, w2) and its
    per-shard clip, so matching them matches those behaviours."""
    want = jax_case["updates"][(2, 2)]
    got = _port_update(None, world4, 2, 2)[0]
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=1e-5)
    md.assert_state_close(got["state"], ttd.train_state_from_jax(want["state"], "cpu"),
                          "(2, 2) vs JAX")
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want["grad_norm"], rtol=1e-5)


def test_train_step_at_world_two_equals_world_one(world2):
    """make_train_step on a (2, 1) mesh with the global noise split by game
    against one rank on every game: trajectories bit-equal in every integer
    field and the reward, params at rtol 1e-5, the same on both ranks."""
    ranks = [r[1] for r in world2["ranks"]]
    md.compare_train(ranks, world2["control"])
    for a, b in zip(ranks[0]["metrics"], world2["control"]["metrics"]):
        assert a["env_steps"] == b["env_steps"] == STEPS * B
        assert a["episodes_done"] == b["episodes_done"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    assert set(ranks[0]["metrics"][0]) == {
        "loss", "grad_norm", "td_abs", "v_mean", "episodes_done", "env_steps",
        "wins_regular", "wins_gammon", "wins_backgammon", "close_out_count", "prime_count",
        "reward_sum", "width_overflow_count"}
    assert int(ranks[0]["state"].version) == 2


def test_world_one_mesh_step_equals_the_single_path(world2):
    """At (1, 1) the mesh step is the single-card loop's update: the same
    state, noise and trajectory through ``rollout_chunked`` + ``td.update``
    give the same trajectory and params."""
    control = world2["control"]
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    state = ttd.init_train_state(TTINY, gen, dev)
    env = tE.reset(B, gen, dev)
    noise = md.global_noise(TTINY, B, 2 * STEPS, 1, dev)
    for u in range(2):
        temp = ttd.temperature(state.version, TTINY)
        env, traj = tR.rollout_chunked(state.params, env, temp, TTINY, STEPS, chunk=4,
                                       device=dev, noise=noise[u * STEPS:(u + 1) * STEPS])
        for f in md.EXACT_FIELDS:
            assert torch.equal(getattr(traj, f), control["traj"][u][f]), f
        state, _ = ttd.update(state, traj, TTINY, dev)
    for k, v in state.params.items():
        np.testing.assert_allclose(control["state"].params[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_ranks_of_one_model_group_take_the_same_decisions(world4):
    """Under tp the ranks of one data index draw the same noise (their data
    generator) and see the same all-reduced values, so their trajectories
    are identical; the two data indices play different games."""
    runs = {(r[1]["data_index"], r[1]["model_index"]): r[1] for r in world4}
    assert sorted(runs) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for di in (0, 1):
        a, b = runs[(di, 0)]["traj"][0], runs[(di, 1)]["traj"][0]
        for f in md.EXACT_FIELDS:
            assert torch.equal(a[f], b[f]), (di, f)
    assert not torch.equal(runs[(0, 0)]["traj"][0]["packed_board"],
                           runs[(1, 0)]["traj"][0]["packed_board"])
    for k, v in runs[(0, 0)]["state"].params.items():
        for r in runs.values():
            assert torch.equal(r["state"].params[k], v), k
        assert torch.isfinite(v).all()


def test_the_step_updates_params_in_their_storage(world2, world4):
    """A rank's params keep their storage across steps, so on a card its
    rollout graph (keyed by params storage) is replayed, not captured
    again."""
    assert all(r[1]["same_storage"] for r in world2["ranks"])
    assert all(r[1]["same_storage"] for r in world4)
    assert world2["control"]["same_storage"]


def test_cli_data2_writes_one_run_and_one_checkpoint(world2):
    """``apps.train --device cpu --data 2`` under two gloo ranks (torchrun's
    environment): rank 0 alone writes, one metrics run with JAX's mesh keys
    and one checkpoint."""
    assert [r[3] for r in world2["ranks"]] == [0, 0]
    d = world2["cli_dir"]
    (run,) = list((d / "runs").iterdir())
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    lines = [x for x in lines if "hist" not in x]
    assert len(lines) == 2
    assert all(np.isfinite(x["loss"]) and x["env_steps"] == 4 * 8 for x in lines)
    assert [p.name for p in (d / "ck").iterdir()] == [f"ckpt_{lines[-1]['step']}.pt"]


def test_cli_fused_rollout_runs_the_mesh_step_at_one_by_one(tmp_path):
    rc = train.main(["--device", "cpu", "--fused-rollout", "--small-movegen",
                     "--batch-games", "8", "--steps-per-update", "4", "--updates", "2",
                     "--checkpoint-dir", str(tmp_path / "ck"),
                     "--metrics-dir", str(tmp_path / "runs"), "--log-every", "1"])
    assert rc == 0
    (run,) = list((tmp_path / "runs").iterdir())
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    lines = [x for x in lines if "hist" not in x]
    assert len(lines) == 2 and all("env_steps" in x and "episodes_done" in x for x in lines)
    assert not torch.distributed.is_initialized()  # the CLI ended the group it made


@pytest.mark.parametrize("flags,reason", [
    (["--model", "2", "--production"], "fused actor kernel"),
    (["--data", "2"], "world has 1"),
    (["--model", "2"], "world has 1"),
    (["--tiered"], "A16"),
], ids=["tp_with_the_fused_kernel", "data_above_the_world", "model_above_the_world",
        "tiered"])
def test_cli_refusals_exit_2(tmp_path, capsys, flags, reason):
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                    "--metrics-dir", str(tmp_path / "runs"), *flags])
    assert e.value.code == 2
    assert reason in capsys.readouterr().err
    assert not (tmp_path / "runs").exists()


def test_step_refuses_tp_with_the_fused_kernel_and_split_tier_noise():
    cfg = TTINY.replace(model=ModelConfig(fused_actor_kernel=True, actor_tier_width=16))
    with pytest.raises(ValueError, match="fused"):
        sharding.make_train_step(None, cfg, 4, tp=True)
    nz = tR.draw_noise(B, cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert nz.gumbel_t2.shape[0] > 0
    with pytest.raises(ValueError, match="sub-batch"):
        sharding.shard_noise([nz], None)


def test_the_launcher_passes_on_the_cpu(capsys):
    """``scripts/multiprocess_distributed.py`` itself: world 2 against one
    rank, and the (1, 2) tp update against the no-tp one and JAX's rule."""
    assert md.main(["--device", "cpu", "--updates", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and abs(out["tp"]["mu_w1_ratio_median"] - 2.0) < 1e-3
