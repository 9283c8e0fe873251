"""The probe's modes with no Pallas kernel behind them (the one-hot
products of ``scripts/probe_pallas_batched_dot.py:99-197``), in the port's
``scripts/probe_take.py`` on the CPU: each gives the exact take at a small
N (13: the int8 modes' one block-diagonal tile is short; chip_smoke.py's
phase 34 runs 128 full tiles at N = 4096), and ``ohonly``,
which takes nothing, prints ``n/a`` as in JAX."""
import pytest

from mlp_ppo_2ply_multi_tpu_torch.scripts import probe_take


@pytest.mark.parametrize("mode", probe_take.XLA_MODES)
def test_probe_mode_is_exact(mode, capsys):
    assert probe_take.main([mode, "13", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("exact: n/a" if mode == "ohonly" else "exact: True")
    assert out[1].startswith(f"{mode}: ")
