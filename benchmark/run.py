"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; ``harness.run`` builds it, warms
it, times the window, reads the trace when ``--trace 1``, and checks the
outputs against the plain reference. The last line of standard output is
one JSON object: correct, attempted, failed, metrics (the end-to-end
metrics, or with --trace 1 the per-layer ones), device, breakdown (traced)
and, last, each number compared with its limit; the same comparisons are
the last lines of standard error.

Exit status 2, with no result: no CUDA card, or fewer than the cell asks
for. 3: the program's package does not import (a checkout without it). 4:
the process holds JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "mlp_ppo_2ply_multi_tpu"}


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def result_line(out: dict, dev_name: str, chips: int, trace: bool) -> dict:
    device = {"platform": "gpu", "kind": dev_name, "count": chips,
              "memory_peak_bytes": int(out["mem_peak"])}
    if trace and "busy_s" in out:
        device.update(busy_s=out["busy_s"], window_s=out["traced_window_s"])
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device,
            "updates": out["updates"], "window_s": out["window_s"],
            "settle_s": out["settle_s"], "reference_s": out["reference_s"]}
    if trace and "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in out["compared"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    chips = int(next((w["chips"] for w in harness.load_json(harness.REPO / "BENCHMARK.json")
                      ["workloads"] if w["name"] == args.workload), 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import mlp_ppo_2ply_multi_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program does not import: {e}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), dev, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}", file=sys.stderr)
        return 4
    line = result_line(out, torch.cuda.get_device_name(0), chips, bool(args.trace))
    for note in out.get("notes", [])[:8]:
        print(f"note: {note}", file=sys.stderr)
    for n, v, lim in out["compared"]:
        print(f"{n} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
