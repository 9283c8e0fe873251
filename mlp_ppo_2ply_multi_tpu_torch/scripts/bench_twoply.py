"""2-ply expectimax throughput: env-steps/s of the 2-ply self-play step.

Port of ``scripts/bench_twoply.py``, with its arguments: ``[batch=1024]
[steps=12] [plain]``. The step is ``Config.production_twoply()`` (the
production actor with the tuned scorer); ``plain`` runs
``production().replace(twoply=TwoPlyConfig(enabled=True))``, the untuned
scorer. JAX's ``_jit_step`` is one dispatch a step, so the counterpart here
is a CUDA graph of one step (``rollout_chunked`` at chunk 1), captured in
the 2 warm-up steps and replayed; ``--eager`` runs the steps through
``rollout_loop`` instead. The window is timed on the host clock and ends
in ``torch.cuda.synchronize()``.

Prints one JSON line: ``metric`` (``env_steps_per_sec_per_chip_2ply``;
``env_steps_per_sec_cpu_2ply`` with ``--device cpu``), ``value``, ``unit``,
``batch``, ``ms_per_step`` and the device. Without a card and without
``--device cpu`` it raises.

Usage: python -m mlp_ppo_2ply_multi_tpu_torch.scripts.bench_twoply \\
    [batch] [steps] [plain] [--eager] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, TwoPlyConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import resolve_device
from mlp_ppo_2ply_multi_tpu_torch.scripts.bench import (
    UNIT,
    card,
    production_config,
    production_twoply_config,
    run,
)

WARMUP = 2  # JAX's two warm-up steps


def config(plain: bool) -> Config:
    """The tuned production 2-ply config, or with ``plain`` the untuned
    scorer on the production actor."""
    if plain:
        return production_config().replace(twoply=TwoPlyConfig(enabled=True))
    return production_twoply_config()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("batch", nargs="?", type=int, default=1024)
    ap.add_argument("steps", nargs="?", type=int, default=12)
    ap.add_argument("plain", nargs="?", choices=("plain",), default=None)
    ap.add_argument("--eager", action="store_true", help="time eager steps, not a graph")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    r = run(args.batch, args.steps, warmup=WARMUP, cfg=config(args.plain == "plain"),
            chunk=1, device=dev, eager=args.eager)
    where = "per_chip" if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": f"env_steps_per_sec_{where}_2ply", "value": r.rate, "unit": UNIT[dev.type],
        "batch": args.batch, "ms_per_step": r.ms_per_step, "eager": args.eager, **card(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
