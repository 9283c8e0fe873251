"""The port stands alone: it never imports JAX or the JAX package, and its
entry points never fall back to the CPU when CUDA was asked for."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "mlp_ppo_2ply_multi_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py"
)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|optax|orbax|mlp_ppo_2ply_multi_tpu)(\s|\.|,|$)",
    re.M,
)


def test_port_imports_no_jax_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        f"for m in {MODULES + ['chip_smoke']!r}:\n"
        "    __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'mlp_ppo_2ply_multi_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_isolation_covers_every_port_module():
    """The checks above walk the whole package and chip_smoke.py: the 2-ply
    modules, both kernels' wrappers, the learner, checkpoints, metrics and
    the training CLI, the row-take kernel and its probe, the oracle copies,
    the arena and the evaluate and play CLIs, the graph cache they share,
    the sorted engine (its hashes, dedup and takes) with its trajectory
    script, the ring buffer, profiling, the fsspec mirror, the mesh
    (distributed, sharding and their multi-process script), the position
    sampler and the rules-parity and quality tools (the rules stress, the
    2-ply decision guard, the learning-curve sweep and the parity trainer)
    are among them."""
    for m in (
        "mlp_ppo_2ply_multi_tpu_torch.twoply.expectimax",
        "mlp_ppo_2ply_multi_tpu_torch.experimental.nd_tail",
        "mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build",
        "mlp_ppo_2ply_multi_tpu_torch.ops.fused_value",
        "mlp_ppo_2ply_multi_tpu_torch.engine.movegen2",
        "mlp_ppo_2ply_multi_tpu_torch.actor.rollout",
        "mlp_ppo_2ply_multi_tpu_torch.learner.td",
        "mlp_ppo_2ply_multi_tpu_torch.io.checkpoint",
        "mlp_ppo_2ply_multi_tpu_torch.io.metrics",
        "mlp_ppo_2ply_multi_tpu_torch.apps.train",
        "mlp_ppo_2ply_multi_tpu_torch.ops.take_rows",
        "mlp_ppo_2ply_multi_tpu_torch.scripts.probe_take",
        "mlp_ppo_2ply_multi_tpu_torch.oracle.rules",
        "mlp_ppo_2ply_multi_tpu_torch.oracle.env",
        "mlp_ppo_2ply_multi_tpu_torch.eval.arena",
        "mlp_ppo_2ply_multi_tpu_torch.apps.render",
        "mlp_ppo_2ply_multi_tpu_torch.apps.evaluate",
        "mlp_ppo_2ply_multi_tpu_torch.apps.play",
        "mlp_ppo_2ply_multi_tpu_torch.core.graphs",
        "mlp_ppo_2ply_multi_tpu_torch.core.tree",
        "mlp_ppo_2ply_multi_tpu_torch.engine.board",
        "mlp_ppo_2ply_multi_tpu_torch.engine.movegen",
        "mlp_ppo_2ply_multi_tpu_torch.scripts.trajectory_parity",
        "mlp_ppo_2ply_multi_tpu_torch.utils.ring_buffer",
        "mlp_ppo_2ply_multi_tpu_torch.utils.profiling",
        "mlp_ppo_2ply_multi_tpu_torch.io.remote",
        "mlp_ppo_2ply_multi_tpu_torch.parallel.distributed",
        "mlp_ppo_2ply_multi_tpu_torch.parallel.sharding",
        "mlp_ppo_2ply_multi_tpu_torch.scripts.multiprocess_distributed",
        "mlp_ppo_2ply_multi_tpu_torch.oracle.sampling",
        "mlp_ppo_2ply_multi_tpu_torch.scripts.stress_movegen2",
        "mlp_ppo_2ply_multi_tpu_torch.scripts.twoply_decision_guard",
        "mlp_ppo_2ply_multi_tpu_torch.scripts.eval_curve",
        "mlp_ppo_2ply_multi_tpu_torch.scripts.run_parity_trainer",
    ):
        assert m in MODULES, m
    assert (ROOT / "chip_smoke.py").exists()


def test_port_sources_name_no_jax_import():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        m = _FORBIDDEN.search(f.read_text())
        assert m is None, f"{f}: {m.group(0)!r}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Without a card, every entry point not given device='cpu' raises."""
    from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
    from mlp_ppo_2ply_multi_tpu_torch.apps import train
    from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
    from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
    from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
    from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint
    from mlp_ppo_2ply_multi_tpu_torch.learner import td
    from mlp_ppo_2ply_multi_tpu_torch.model import value_net
    from mlp_ppo_2ply_multi_tpu_torch.scripts import (
        eval_curve,
        run_parity_trainer,
        stress_movegen2,
        twoply_decision_guard,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    for make in (
        lambda: stress_movegen2.main(["1"]),
        lambda: stress_movegen2.run("a", 1),
        lambda: twoply_decision_guard.main(["8"]),
        lambda: eval_curve.main([str(tmp_path)]),
        lambda: run_parity_trainer.main(["--episodes", "8", "--out", str(tmp_path / "p")]),
    ):
        with pytest.raises(RuntimeError):
            make()
    assert not (tmp_path / "p").exists()
    with pytest.raises(RuntimeError):
        vec_env.reset(8)
    cfg = Config.production()
    ckpt = str(ROOT / "checkpoints" / "side0_20480000.pth")
    for make in (
        lambda: value_net.init_params(cfg.model),
        lambda: value_net.load_checkpoint(ckpt),
        lambda: value_net.from_state_dict(torch.load(ckpt, weights_only=True)),
        lambda: value_net.params_from_jax(value_net.init_params(cfg.model, device="cpu")),
        lambda: td.init_train_state(cfg),
        lambda: checkpoint.restore(str(tmp_path)),
        lambda: train.main(["--updates", "1", "--checkpoint-dir", str(tmp_path / "c"),
                            "--metrics-dir", str(tmp_path / "m")]),
    ):
        with pytest.raises(RuntimeError):
            make()
    assert not (tmp_path / "m").exists()
    params = value_net.init_params(cfg.model, device="cpu")
    state = td.init_train_state(cfg, device="cpu")
    st = vec_env.reset(8, device="cpu")
    _, traj = rollout.rollout_loop(params, st, 1.0, cfg, 2, True, device="cpu")
    with pytest.raises(RuntimeError):  # a CPU state, the card asked for
        td.update(state, traj, cfg)
    with pytest.raises(RuntimeError):
        rollout.rollout_step(params, st, 1.0, cfg, True)
    with pytest.raises(RuntimeError):
        rollout.rollout_loop(params, st, 1.0, cfg, 1)
    with pytest.raises(RuntimeError):
        rollout.rollout_step(params, st, 1.0, Config.production_twoply(), True)
    with pytest.raises(RuntimeError):
        rollout.rollout_chunked(params, st, 1.0, cfg, 4)
    with pytest.raises(RuntimeError):
        rollout.rollout(params, st, 1.0, cfg, 4)
    _, chunked = rollout.rollout_chunked(params, st, 1.0, cfg, 4, device="cpu")
    _, scanned = rollout.rollout(params, st, 1.0, cfg, 2, continuous=True, device="cpu")
    assert chunked.reward.shape == (4, 8) and scanned.reward.shape == (2, 8)
    assert resolve_device("cpu").type == "cpu"


def test_eval_entry_points_raise_without_cuda(monkeypatch):
    """The evaluate and play CLIs, the arena, the take probe and the
    trajectory script run on the card unless asked for the CPU; without one
    they raise."""
    from mlp_ppo_2ply_multi_tpu_torch.apps import evaluate, play
    from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
    from mlp_ppo_2ply_multi_tpu_torch.eval import arena
    from mlp_ppo_2ply_multi_tpu_torch.model import value_net
    from mlp_ppo_2ply_multi_tpu_torch.scripts import probe_take, trajectory_parity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    params = value_net.init_params(cfg.model, device="cpu")
    pol = arena.random_policy(cfg)
    for make in (
        lambda: evaluate.main(["--games", "2", "--max-steps", "1"]),
        lambda: probe_take.main(["gather", "4"]),
        lambda: trajectory_parity.main(["torch", "--games", "2"]),
        lambda: arena.play_match(params, params, pol, pol, None, cfg, 2, 1),
        lambda: play.TorchEngine({k: v.numpy() for k, v in params.items()}),
    ):
        with pytest.raises(RuntimeError):
            make()


def test_rollout_step_refuses_state_on_another_device():
    """A state on the CPU is not quietly run when the caller asked for
    another device (here 'meta', which exists everywhere)."""
    from mlp_ppo_2ply_multi_tpu_torch.core.device import check_on

    with pytest.raises(ValueError):
        check_on(torch.zeros(2), torch.device("meta"), "state")
    check_on(torch.zeros(2), torch.device("cpu"), "state")


def test_chip_smoke_alone_exits_1_naming_the_package(tmp_path):
    """Copied alone into an empty directory, chip_smoke.py finds no port
    beside it: one line names the package and the directory, exit 1, and
    no result line, with or without a card."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    said = (out.stdout + out.stderr).strip().splitlines()
    assert len(said) == 1 and "mlp_ppo_2ply_multi_tpu_torch" in said[0]
    assert str(tmp_path) in said[0] and '"ok"' not in out.stdout
