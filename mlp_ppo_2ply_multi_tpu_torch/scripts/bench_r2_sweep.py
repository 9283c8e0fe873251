"""A sweep of rollout-step variants: env-steps/s of each, one JSON line a
variant.

Port of ``scripts/bench_r2_sweep.py``, with its variant names, defaults
and ``@N`` batch suffix. Each variant is the production rollout step under
one change of config, driven as JAX drives one jitted step: here a CUDA
graph of one step (``scripts.bench.run`` at chunk 1), captured in the
warm-up and replayed. Variants:

  prod          ``Config.production()``
  tier0         the non-doubles tail single-pass (``nd_tier=0``)
  tiered        the tiered pipeline (``movegen.tiered``, ``dd_tier=(48, 96, 96)``)
  prod_ddAxBxC  the two-tier doubles expansion alone, ``dd_tier=(A, B, C)``
                (``prod_dd`` alone: 48x96x96)
  split         ``split_planes=True`` (already the production setting)
  prod_notier   no two-tier candidate evaluation (``actor_tier_width=0``)
  prod_gram     the Gram dedup (``nd_sig_dedup=False``)
  twoply        ``TwoPlyConfig(enabled=True)``, the untuned scorer
  twoply_tuned  ``Config.production_twoply()``
  twoply_scan   the scan scorer (``unroll_rolls=False``)
  twoply_vf0    value-first replies off (``value_first_m=0``)
  twoply_vf16   value-first replies on (``value_first_m=16``)
  twoply_tier   the two-tier reply tail (``reply_nd_tier=96``,
                ``reply_wide_div=2``, value-first off)

A name starting ``twoply`` takes ``--twoply-batch`` and ``--twoply-steps``
and 3 warm-up steps, the others ``--batch`` and ``--steps`` and 8. A
variant that fails to run prints a JSON line naming it and its error, and
the sweep exits 1 after the others; an unknown name exits 2.

Usage: python -m mlp_ppo_2ply_multi_tpu_torch.scripts.bench_r2_sweep \\
    [--batch 4096] [--steps 30] [--twoply-batch 1024] [--twoply-steps 8] \\
    [--variants prod,tier0,twoply,twoply_tier] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, TwoPlyConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.scripts.bench import (
    card,
    production_config,
    production_twoply_config,
    run,
)

DEFAULT_VARIANTS = ("prod,prod_gram,tier0,tiered,prod@8192,tiered@8192,"
                    "twoply,twoply_vf0,twoply_tier,twoply@4096")


def variant_cfg(name: str) -> Config:
    """The config of a variant (module docstring). Raises SystemExit on an
    unknown name, as JAX's does."""
    cfg = production_config()
    mg = lambda **kw: cfg.replace(movegen=dataclasses.replace(cfg.movegen, **kw))
    if name == "prod":
        return cfg
    if name == "tier0":
        return mg(nd_tier=0)
    if name == "tiered":
        return mg(tiered=True, dd_tier=(48, 96, 96))
    if name.startswith("prod_dd"):
        widths = name[len("prod_dd"):] or "48x96x96"
        return mg(dd_tier=tuple(int(w) for w in widths.split("x")))
    if name == "split":
        return mg(split_planes=True)
    if name == "prod_notier":
        return cfg.replace(model=dataclasses.replace(cfg.model, actor_tier_width=0))
    if name == "prod_gram":
        return mg(nd_sig_dedup=False)
    if name == "twoply":
        return cfg.replace(twoply=TwoPlyConfig(enabled=True))
    if name == "twoply_tuned":
        return production_twoply_config()
    if name == "twoply_scan":
        return cfg.replace(twoply=TwoPlyConfig(enabled=True, unroll_rolls=False))
    if name == "twoply_vf0":
        return cfg.replace(twoply=TwoPlyConfig(enabled=True, value_first_m=0))
    if name == "twoply_vf16":
        return cfg.replace(twoply=TwoPlyConfig(enabled=True, value_first_m=16))
    if name == "twoply_tier":
        return cfg.replace(twoply=TwoPlyConfig(
            enabled=True, value_first_m=0, reply_nd_tier=96, reply_wide_div=2))
    raise SystemExit(f"unknown variant {name}")


def plan(name: str, batch: int, steps: int, twoply_batch: int, twoply_steps: int):
    """(config, batch, steps, warm-up steps) of a variant name, with its
    optional ``@N`` batch."""
    base, _, suffix = name.partition("@")
    two = base.startswith("twoply")
    b = int(suffix) if suffix else (twoply_batch if two else batch)
    return variant_cfg(base), b, (twoply_steps if two else steps), (3 if two else 8)


def bench_rollout(cfg: Config, batch: int, steps: int, warmup: int,
                  device: DeviceLike = None) -> float:
    """env-steps/s of ``steps`` graphed steps of one step each, after
    ``warmup`` (at least 2)."""
    return run(batch, steps, warmup=warmup, cfg=cfg, chunk=1, device=device).rate


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--twoply-batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--twoply-steps", type=int, default=8)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    plans = {name: plan(name, args.batch, args.steps, args.twoply_batch, args.twoply_steps)
             for name in args.variants.split(",")}
    where = card(dev)
    failed = []
    for name, (cfg, b, s, warm) in plans.items():
        t0 = time.perf_counter()
        try:
            rate = bench_rollout(cfg, b, s, warm, dev)
        except Exception as e:  # a variant the port cannot run is named, not skipped
            failed.append(name)
            print(json.dumps({"variant": name, "batch": b, "error": f"{type(e).__name__}: {e}",
                              **where}), flush=True)
            continue
        print(json.dumps({"variant": name, "batch": b, "env_steps_per_s": rate,
                          "wall_s": time.perf_counter() - t0, **where}), flush=True)
    if failed:
        print(f"bench_r2_sweep: variants that did not run: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
