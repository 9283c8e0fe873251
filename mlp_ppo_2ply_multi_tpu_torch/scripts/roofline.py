"""Roofline of the production 1-ply step and the 2-ply step on one card.

Port of ``scripts/roofline.py``, with its modes ``oneply|twoply|peaks|all``.
For each step it reports:

  1. ms a step and env-steps/s of the graphed step, timed as
     ``scripts.bench`` times it: the 1-ply step (``Config.production()``)
     at B = 4096 as a graph of 4 steps, the 2-ply step
     (``Config.production_twoply()``) at B = 1024 as a graph of one;
  2. flops, elementwise ops and bytes a dispatch (one graph replay) from
     ``utils.cost``, counted on the same steps run eagerly (the graph
     replays the same ops), and the intensity (flops a byte);
  3. achieved TFLOP/s and GB/s, as fractions of the H100's published peaks
     (989 TFLOP/s bf16, 3.35 TB/s, at 700 W) and of the peaks measured on
     this card (``peaks``).

``peaks`` measures the launch floor (a trivial op launched 50 times
pipelined, then 10 times with a synchronise after each), the bf16 matmul
ceiling (8 chained 8192^3 ``torch.matmul`` a repeat, 10 repeats; a peak
probe, so a library call) and the HBM ceiling (an in-place add over a 1 GB
f32 buffer, 16 a repeat: 2 reads and 1 write each). Every result carries
the card's name and power limit. ``--out`` writes them all as JSON.

``--device cpu`` measures nothing: it prints each step's counts a
dispatch (``utils.cost``) at B = 32 (1-ply) and B = 8 (2-ply), with no
time, rate or fraction. Without a card and without ``--device cpu`` it
raises.

Usage: python -m mlp_ppo_2ply_multi_tpu_torch.scripts.roofline \\
    [oneply|twoply|peaks|all] [--out roofline.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.scripts.bench import (
    card,
    chunk_cost,
    production_config,
    production_twoply_config,
    run,
    setup,
)
from mlp_ppo_2ply_multi_tpu_torch.utils import cost as costs

# (name, config, batch, chunk) of each step (the benches' configurations)
STEPS = {
    "oneply": ("1ply_production", production_config, 4096, 4),
    "twoply": ("2ply_production", production_twoply_config, 1024, 1),
}
DISPATCHES = 30  # timed graph replays (JAX: 30 dispatches after 3 warm-up)
CPU_BATCH = {"oneply": 32, "twoply": 8}  # --device cpu: counts only


def _events_ms(fn, dev: torch.device) -> float:
    """Device ms of ``fn()`` between two CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1)


def measure_launch_floor(dev: torch.device) -> Dict[str, float]:
    """A trivial op (a 0-d add) launched 50 times back to back and waited
    for once (host ms a launch, pipelined), then 10 times with a
    synchronise after each (ms a launch and round trip)."""
    x = torch.zeros((), device=dev)
    x = x + 1.0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(50):
        x = x + 1.0
    torch.cuda.synchronize(dev)
    pipelined = (time.perf_counter() - t0) / 50 * 1e3
    t0 = time.perf_counter()
    for _ in range(10):
        x = x + 1.0
        torch.cuda.synchronize(dev)
    roundtrip = (time.perf_counter() - t0) / 10 * 1e3
    return {"launch_pipelined_ms": pipelined, "launch_roundtrip_ms": roundtrip}


def measure_peak_flops(dev: torch.device, n: int = 8192, chain: int = 8,
                       reps: int = 10) -> float:
    """bf16 matmul ceiling in TFLOP/s: ``chain`` chained n^3 products a
    repeat (each output feeds the next), ``reps`` repeats between CUDA
    events after a warm-up repeat."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, n), generator=g, device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=g, device=dev, dtype=torch.bfloat16) / n ** 0.5

    def chained():
        nonlocal x
        for _ in range(chain):
            x = torch.matmul(x, b)

    chained()
    torch.cuda.synchronize(dev)
    ms = _events_ms(lambda: [chained() for _ in range(reps)], dev)
    return 2 * n ** 3 * chain * reps / (ms / 1e3) / 1e12


def measure_peak_bw(dev: torch.device, gbytes: float = 1.0, chain: int = 16,
                    reps: int = 4) -> float:
    """HBM ceiling in GB/s: ``x += b`` over two f32 buffers of ``gbytes``
    GB, ``chain`` times a repeat (2 reads and 1 write of the buffer each),
    ``reps`` repeats between CUDA events after a warm-up repeat."""
    n = int(gbytes * 1024 ** 3) // 4
    x = torch.ones(n, device=dev)
    b = torch.full((n,), 1e-9, device=dev)

    def adds():
        for _ in range(chain):
            x.add_(b)

    adds()
    torch.cuda.synchronize(dev)
    ms = _events_ms(lambda: [adds() for _ in range(reps)], dev)
    return 3 * n * 4 * chain * reps / (ms / 1e3) / 1e9


def peaks(dev: torch.device) -> Dict[str, float]:
    out = measure_launch_floor(dev)
    out["measured_peak_tflops_bf16"] = measure_peak_flops(dev)
    out["measured_peak_hbm_gbs"] = measure_peak_bw(dev)
    out["published_peak_tflops_bf16"] = costs.BF16_FLOP_PER_S / 1e12
    out["published_peak_hbm_gbs"] = costs.HBM_BYTES_PER_S / 1e9
    return out


def analyze(which: str, dev: torch.device, dispatches: int = DISPATCHES) -> Dict[str, object]:
    """Time the graphed step of ``STEPS[which]`` and count one dispatch."""
    name, make_cfg, batch, chunk = STEPS[which]
    cfg: Config = make_cfg()
    cost: dict = {}
    r = run(batch, dispatches * chunk, warmup=3 * chunk, cfg=cfg, chunk=chunk, cost=cost,
            device=dev)
    disp_s = r.ms_per_step * chunk / 1e3
    flops, nbytes = cost["flops_per_disp"], cost["hbm_bytes_per_disp"]
    return {
        "workload": name, "batch": batch, "steps_per_disp": chunk,
        "ms_per_step": r.ms_per_step, "env_steps_per_s": r.rate,
        "flops_per_disp": flops,
        "elementwise_ops_per_disp": cost["elementwise_ops_per_disp"],
        "hbm_bytes_per_disp": nbytes,
        **costs.roofline(flops, nbytes, disp_s),
    }


def cpu_counts(which: str) -> Dict[str, object]:
    """One dispatch's counts of ``STEPS[which]`` on the CPU at
    ``CPU_BATCH``: no time, rate or fraction."""
    name, make_cfg, _, chunk = STEPS[which]
    batch = CPU_BATCH[which]
    cfg: Config = make_cfg()
    dev = torch.device("cpu")
    params, state, temp, _ = setup(cfg, batch, dev)
    c = chunk_cost(params, state, temp, cfg, chunk, dev)
    return {"workload": name, "batch": batch, "steps_per_disp": chunk,
            "flops_per_disp": c.flops, "elementwise_ops_per_disp": c.elementwise_ops,
            "hbm_bytes_per_disp": c.bytes, "device": "cpu"}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("which", nargs="?", choices=("oneply", "twoply", "peaks", "all"),
                    default="all")
    ap.add_argument("--out", default=None, help="write every result here as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        counts = {w: cpu_counts(w) for w in STEPS if args.which in (w, "all")}
        for r in counts.values():
            print(json.dumps(r), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(counts, f, indent=1)
        return 0
    where = card(dev)
    out: Dict[str, object] = {**where}
    if args.which in ("peaks", "all"):
        out.update(peaks(dev))
        print(json.dumps(out), flush=True)
    for label in ("oneply", "twoply"):
        if args.which not in (label, "all"):
            continue
        r = analyze(label, dev)
        if "measured_peak_tflops_bf16" in out:
            r["mfu_vs_measured"] = r["achieved_tflops"] / out["measured_peak_tflops_bf16"]
            r["bw_frac_vs_measured"] = r["achieved_gbs"] / out["measured_peak_hbm_gbs"]
        r.update(where)
        out[label] = r
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
