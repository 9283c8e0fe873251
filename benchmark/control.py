"""Readings that set the limits of ``correct``: the sound program, the
control and the planted faults, each through the cell's set-up (the
checked updates, no window) and the reference check.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 ... \\
        [--controls 3] [--faults stuck half alter] [--fault-seeds 3] [--out f.jsonl]

For each seed: the numbers of the sound program. For the first
``--controls`` seeds also the control: the reference put in the program's
place one precision below the configuration's (the learner's products in
TF32, the actor's values in fp8). For each fault (``faults.py``) the
numbers of the program with it planted, on the first ``--fault-seeds``
seeds. One JSON line a reading; on a card only (exit 2 without one).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch


def readings(workload: str, seeds, controls: int, faults, fault_seeds: int, dev,
             emit=print, overrides=None, workers=None) -> list:
    from benchmark import harness
    from benchmark.faults import planted
    from mlp_ppo_2ply_multi_tpu_torch.core.graphs import clear_graphs

    files = harness.cell_files(workload)
    conf, traffic = dict(files.config), dict(files.traffic)
    conf.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    out = []

    drv = harness.driver(traffic["kind"])

    def one(seed, kind, fault=None):
        t0 = time.perf_counter()
        with planted(fault) if fault else contextlib.nullcontext():
            record = drv.set_up(conf, traffic, seed, dev, harness.REPO).finish()
        clear_graphs()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res = {}
        modes = [("sound", None)] + ([("control", "tf32_fp8")] if kind == "control" else [])
        for mode, ctl in modes:
            r = drv.check(conf, traffic, record, files.limits, seed, dev, harness.REPO, workers,
                          control=ctl)
            line = {"workload": workload, "seed": seed, "reading": fault or mode,
                    "correct": r["correct"], **r["numbers"],
                    "greedy_checked": r["greedy_checked"],
                    "twoply_checked": r.get("twoply_checked", 0),
                    "sampled_1ply": r["sampled_1ply"], "sampled_2ply": r["sampled_2ply"],
                    "leaves_left_out": r["learner"]["leaves_left_out"],
                    "grad_leaf": r["learner"]["grad_leaf"], "step_leaf": r["learner"]["step_leaf"],
                    "notes": r["notes"][:2], "s": round(time.perf_counter() - t0, 2)}
            emit(json.dumps(line))
            out.append(line)
            res[mode] = line
        return res

    for i, seed in enumerate(seeds):
        one(seed, "control" if i < controls else "sound")
    for f in faults:
        for seed in seeds[:fault_seeds]:
            one(seed, "fault", f)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=["half", "alter", "hot", "noise_row"])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    f = open(args.out, "a") if args.out else None

    def emit(s):
        print(s, flush=True)
        if f:
            f.write(s + "\n")
            f.flush()

    try:
        readings(args.workload, args.seeds, args.controls, args.faults, args.fault_seeds,
                 torch.device("cuda", 0), emit)
    finally:
        if f:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
