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


def test_port_sources_name_no_jax_import():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        m = _FORBIDDEN.search(f.read_text())
        assert m is None, f"{f}: {m.group(0)!r}"


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without a card, every entry point not given device='cpu' raises."""
    from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
    from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
    from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
    from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
    from mlp_ppo_2ply_multi_tpu_torch.model import value_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        vec_env.reset(8)
    cfg = Config.production()
    params = value_net.init_params(cfg.model)
    st = vec_env.reset(8, device="cpu")
    with pytest.raises(RuntimeError):
        rollout.rollout_step(params, st, 1.0, cfg, True)
    with pytest.raises(RuntimeError):
        rollout.rollout_loop(params, st, 1.0, cfg, 1)
    assert resolve_device("cpu").type == "cpu"


def test_rollout_step_refuses_state_on_another_device():
    """A state on the CPU is not quietly run when the caller asked for
    another device (here 'meta', which exists everywhere)."""
    from mlp_ppo_2ply_multi_tpu_torch.core.device import check_on

    with pytest.raises(ValueError):
        check_on(torch.zeros(2), torch.device("meta"), "state")
    check_on(torch.zeros(2), torch.device("cpu"), "state")
