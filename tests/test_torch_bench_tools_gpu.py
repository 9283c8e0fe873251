"""The port's measurement tools once each on the card, at small sizes: the
1-ply bench's graphed run (its kernel launches and fractions), the 2-ply
bench, the sweep, the weak-scaling bench on one NCCL rank, the roofline's
peak probes, and trace_attr's two views of one step, whose count equals the
CPU's.

These tests need a CUDA card; the ``card`` fixture skips them elsewhere.
The file imports torch and the port only, so on the card it runs without
JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bench_tools_gpu.py
"""
import json

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value
from mlp_ppo_2ply_multi_tpu_torch.scripts import (
    bench,
    bench_r2_sweep,
    bench_spmd,
    bench_twoply,
    roofline,
    trace_attr,
)
from mlp_ppo_2ply_multi_tpu_torch.utils import cost

CEILING = 1.05  # a fraction of a published peak above this means a wrong count


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the tools measure the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


@pytest.mark.gpu
def test_bench_graphed_run_launches_and_fractions(card):
    before = fused_value.KERNEL.launches
    r = bench.run(512, 8, warmup=8, cfg=bench.production_config(), chunk=4, device=card)
    assert fused_value.KERNEL.launches - before == 2 * r.steps and r.rate > 0
    counts: dict = {}
    bench.run(512, 8, cfg=bench.production_config(), chunk=4, cost=counts, device=card)
    fr = bench.fractions(counts, r.rate, 512)
    assert 0 < fr["mfu"] <= CEILING and 0 < fr["achieved_bw_frac"] <= CEILING


@pytest.mark.gpu
def test_bench_twoply_and_sweep_lines(card, capsys):
    assert bench_twoply.main(["64", "2"]) == 0
    (two,) = _lines(capsys)
    assert two["metric"] == "env_steps_per_sec_per_chip_2ply" and two["value"] > 0
    assert two["device"] == torch.cuda.get_device_name(0) and "W" in two["nvidia_smi"]
    assert bench_r2_sweep.main(["--batch", "256", "--steps", "2", "--twoply-batch", "64",
                                "--twoply-steps", "1", "--variants", "prod,twoply_tuned"]) == 0
    assert [x["variant"] for x in _lines(capsys)] == ["prod", "twoply_tuned"]


@pytest.mark.gpu
def test_bench_spmd_one_nccl_rank(card, capsys):
    assert bench_spmd.main(["--per-device-batch", "256", "--num-steps", "8",
                            "--steps", "2"]) == 0
    (out,) = _lines(capsys)
    assert out["devices"] == 1 and out["env_steps_per_s"] > 0


@pytest.mark.gpu
def test_roofline_peak_probes_under_the_published_peaks(card):
    floor = roofline.measure_launch_floor(card)
    assert 0 < floor["launch_pipelined_ms"] < 1 and 0 < floor["launch_roundtrip_ms"] < 10
    tflops = roofline.measure_peak_flops(card, n=4096, chain=2, reps=2)
    assert 0 < tflops <= CEILING * cost.BF16_FLOP_PER_S / 1e12
    gbs = roofline.measure_peak_bw(card, gbytes=0.25, chain=4, reps=2)
    assert 0 < gbs <= CEILING * cost.HBM_BYTES_PER_S / 1e9


@pytest.mark.gpu
def test_trace_attr_views_and_the_card_count_equals_the_cpus(card):
    a = trace_attr.attribute("prod", 512, card)
    tags = {p for t in a["stages"] for p in t.split("/")}
    assert {"nd_front", "nd_tail_t1", "act_t1", "env_step"} <= tags
    assert a["attributed_ms"] > 0 and a["device_ms"] > 0 and a["total_bytes"] > 0
    cfg = bench.production_config()
    params, state, temp, _ = bench.setup(cfg, 128, card)
    cpu = torch.device("cpu")
    on_card = bench.chunk_cost(params, state, temp, cfg, 1, card)
    on_cpu = bench.chunk_cost({k: v.cpu() for k, v in params.items()},
                              tmap(lambda t: t.cpu(), state), temp.cpu(), cfg, 1, cpu)
    assert on_card.by_tag == on_cpu.by_tag
