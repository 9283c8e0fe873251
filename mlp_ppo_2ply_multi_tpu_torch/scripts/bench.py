"""Headline benchmark: 1-ply self-play env-steps/s on one card.

Port of the JAX package's root ``bench.py``. It measures the actor's whole
step (move enumeration -> values of the candidates through the fused board
-> value kernel -> softmax(V/T) sampling -> env transition) in continuous
rollout mode at ``Config.production()``, B = 4096, through
``actor.rollout_chunked``: a CUDA graph of ``chunk`` (4) steps, captured
once and replayed, is the counterpart of JAX's jitted, donated
``lax.scan`` of chunk steps. The window is timed on the host clock and ends
in ``torch.cuda.synchronize()``; warm-up and capture stay outside it.
``--eager`` also runs the same steps through ``actor.rollout_loop`` (every
op dispatched from Python) and reports them beside the graphed ones.

Prints ONE JSON line: ``metric``, ``value``, ``unit``, ``ms_per_step``, the
card (``torch.cuda.get_device_name(0)`` and nvidia-smi's name and power
limit), and ``mfu`` and ``achieved_bw_frac``: one chunk's flops and bytes
(``utils.cost``, counted on an eager chunk) at the measured rate, against
the H100's published bf16 and HBM peaks. No TPU number is a target here.

``--device cpu`` is the CPU smoke mode of JAX's bench: B = 32, reduced
movegen widths, 4 steps, warm-up 1, chunk 1, no fractions, and a metric
whose name says ``cpu``. Without a card and without ``--device cpu`` it
raises.

Usage: python -m mlp_ppo_2ply_multi_tpu_torch.scripts.bench [--eager] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.utils import cost as costs

UNIT = {"cuda": "env-steps/s/chip", "cpu": "env-steps/s"}
# the CPU smoke mode's widths (JAX bench.py:116)
SMOKE_MOVEGEN = MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64)


def production_config() -> Config:
    """Single authority: core/config.py Config.production."""
    return Config.production()


def production_twoply_config() -> Config:
    """Single authority: core/config.py Config.production_twoply (the tuned
    scorer of TwoPlyConfig.tuned)."""
    return Config.production_twoply()


def card(dev: torch.device) -> Dict[str, str]:
    """The device a result was measured on: torch's name of the card and
    nvidia-smi's name and power limit (a card set below 700 W runs slower
    under load); {"device": "cpu"} for the CPU."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(idx), "nvidia_smi": smi[idx]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run(NamedTuple):
    rate: float  # env-steps/s over the timed window
    ms_per_step: float
    steps: int  # steps driven in all: warm-up, then timed
    state: vec_env.EnvState  # the state after them


def setup(cfg: Config, batch: int, dev: torch.device, seed: int = 0):
    """(params, state, temperature, generator) of a bench run: fresh params
    and games from one seeded generator on ``dev``, version-0 temperature."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = td.init_train_state(cfg, gen, dev).params
    state = vec_env.reset(batch, gen, dev)
    temp = td.temperature(torch.zeros((), dtype=torch.int32, device=dev), cfg)
    return params, state, temp, gen


def chunk_cost(params, state, temp, cfg: Config, chunk: int, dev: torch.device,
               seed: int = 1) -> costs.StepCost:
    """``utils.cost`` of one chunk: ``chunk`` eager steps from ``state``
    (not changed), their noise from a generator of its own, after one
    uncounted step that makes the step's device constants."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    actor.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
    return costs.step_cost(
        lambda: actor.rollout_loop(params, state, temp, cfg, chunk, True, gen=gen, device=dev))


def run(
    batch: int,
    steps: int,
    warmup: int = 8,
    cfg: Optional[Config] = None,
    chunk: int = 4,
    cost: Optional[dict] = None,
    device: DeviceLike = None,
    eager: bool = False,
) -> Run:
    """max(warmup // chunk, 2) chunks of warm-up (the first one captures the
    graph), then max(steps // chunk, 1) chunks timed, from seed 0, in
    continuous mode; graphed through ``rollout_chunked`` or, with
    ``eager``, through ``rollout_loop``. ``cost`` (a dict) receives one
    chunk's ``flops_per_disp``, ``elementwise_ops_per_disp``,
    ``hbm_bytes_per_disp`` and ``steps_per_disp``, counted before the
    warm-up."""
    dev = resolve_device(device)
    cfg = cfg or Config()
    params, state, temp, gen = setup(cfg, batch, dev)
    if cost is not None:
        c = chunk_cost(params, state, temp, cfg, chunk, dev)
        cost.update(flops_per_disp=c.flops, elementwise_ops_per_disp=c.elementwise_ops,
                    hbm_bytes_per_disp=c.bytes, steps_per_disp=chunk)

    def drive(n_chunks: int, st):
        n = n_chunks * chunk
        if eager:
            return actor.rollout_loop(params, st, temp, cfg, n, True, gen=gen, device=dev)[0]
        return actor.rollout_chunked(params, st, temp, cfg, n, chunk=chunk, continuous=True,
                                     gen=gen, device=dev)[0]

    n_warm = max(warmup // chunk, 2)
    n_disp = max(steps // chunk, 1)
    state = drive(n_warm, state)
    _sync(dev)
    t0 = time.perf_counter()
    state = drive(n_disp, state)
    _sync(dev)
    dt = time.perf_counter() - t0
    timed = n_disp * chunk
    return Run(batch * timed / dt, dt / timed * 1e3, (n_warm + n_disp) * chunk, state)


def fractions(cost: dict, rate: float, batch: int) -> Dict[str, float]:
    """mfu and achieved_bw_frac of one chunk's counts at ``rate``
    env-steps/s, against the H100's published peaks."""
    r = costs.roofline(cost["flops_per_disp"], cost["hbm_bytes_per_disp"],
                       batch * cost["steps_per_disp"] / rate)
    return {"mfu": r["mfu_vs_datasheet"], "achieved_bw_frac": r["bw_frac_vs_datasheet"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--eager", action="store_true",
                    help="also time the same steps through rollout_loop")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        batch, kw = 4096, dict(steps=50, cfg=production_config())
        cost: Optional[dict] = {}
        metric = "env_steps_per_sec_per_chip_1ply"
    else:
        # CPU smoke mode: tiny shapes and reduced movegen widths
        batch, kw = 32, dict(steps=4, warmup=1, cfg=Config(movegen=SMOKE_MOVEGEN), chunk=1)
        cost = None
        metric = "env_steps_per_sec_cpu_1ply"
    r = run(batch, cost=cost, device=dev, **kw)
    out = {"metric": metric, "value": r.rate, "unit": UNIT[dev.type],
           "ms_per_step": r.ms_per_step, "batch": batch, "chunk": kw.get("chunk", 4)}
    if args.eager:
        e = run(batch, device=dev, eager=True, **kw)
        out.update(eager_value=e.rate, eager_ms_per_step=e.ms_per_step)
    if cost:
        out.update(fractions(cost, r.rate, batch))
    out.update(card(dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
