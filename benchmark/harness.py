"""One run of one cell: set-up, the timed window, the traced reading, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file the harness finds by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json`` (named by the configuration's ``file``),
``traffic/<traffic>.json``, ``metrics/<metric>.py`` (a ``read(ctx)`` that
returns a number or None) and ``limits/<workload>.json`` (the limit of each
number ``correct`` compares). The traffic mix's ``kind`` names its driver,
``drivers/<kind>.py``, which builds the cell, does one unit of its work and
checks the outputs; the configuration's ``reference`` names its plain
reference under ``reference/``. A cell of a new kind adds a driver file and
edits none.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, List, Optional

import torch

from benchmark.loader import load_module

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, root: Path = REPO) -> SimpleNamespace:
    """The spec, the workload entry and its configuration, traffic mix,
    limits and per-layer metric entries, found by name."""
    spec = load_json(root / "BENCHMARK.json")
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    centry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    here = root / HERE.name
    layer = [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    return SimpleNamespace(
        spec=spec, workload=wl, config=load_json(root / centry["file"]),
        traffic=load_json(here / "traffic" / f"{wl['traffic']}.json"),
        limits=load_json(here / "limits" / f"{workload}.json"),
        per_layer=layer, end_to_end=e2e)


def metric_reader(name: str, root: Path = REPO) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    return load_module(root, "metrics", name).read


def driver(kind: str, root: Path = REPO):
    """The driver of traffic kind ``kind``: ``drivers/<kind>.py``, with
    ``set_up`` (returns the cell: ``work``, ``end_to_end``, ``profiled``,
    ``eager_step``, ``finish``) and ``check`` (the reference check)."""
    return load_module(root, "drivers", kind)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run(workload: str, seed: int, seconds: float, trace: bool, dev: torch.device,
        t_start: float, root: Path = REPO, workers: Optional[int] = None,
        overrides: Optional[dict] = None) -> dict:
    """Set-up, window, traced reading (``trace``), reference check; returns
    the result dict (correct, attempted, failed, metrics, device, ...) and
    the comparison lines under ``compared``. ``overrides`` replaces keys of
    the configuration and the traffic (tests run small cells on the CPU)."""
    files = cell_files(workload, root)
    conf, traffic = dict(files.config), dict(files.traffic)
    for k, v in (overrides or {}).get("config", {}).items():
        conf[k] = v
    for k, v in (overrides or {}).get("traffic", {}).items():
        traffic[k] = v
    drv = driver(traffic["kind"], root)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # ---- set-up: the cell, driven through the work its check reads
    cell = drv.set_up(conf, traffic, seed, dev, root)
    sync()
    setup_s = time.perf_counter() - t_start
    # a fresh process on the card runs graphs of small kernels ~14% slower
    # for its first tens of seconds (PERF.md); the work runs on,
    # unmeasured, until the process is ``settle_s`` old
    settle_until = t_start + float(traffic.get("settle_s", 0))
    while time.perf_counter() < settle_until:
        cell.work()
    sync()
    settle_s = time.perf_counter() - t_start - setup_s

    # ---- the window
    times: List[float] = []
    spans: Optional[list] = [] if trace else None
    counts: List[dict] = []
    prof_out = None
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        c = cell.work(spans=spans, count=trace)
        te = time.perf_counter()
        times.append(te - ts)
        if c is not None:
            counts.append(c)
        if te - t0 >= seconds:
            break
    window = te - t0
    sync()
    n_work = len(times)
    if trace:
        # the traced window ends with units of work under the profiler
        prof_out = cell.profiled(int(traffic.get("profiled_updates", 1)))
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # ---- traced: one eager step under the profiler, by scope
    eager = cell.eager_step() if trace else None
    e2e = {**cell.end_to_end(times, window), "peak_mem_gib": mem_peak / 2**30,
           "setup_s": setup_s}
    ctx = SimpleNamespace(cfg=cell.cfg, conf=conf, traffic=traffic, workload=workload,
                          spans=spans, counts=counts, prof=prof_out, eager=eager, e2e=e2e,
                          steps=cell.steps, batch=cell.batch, cuda=cuda)
    # what the check needs from the program; then the program's state is freed
    record = cell.finish()
    del cell

    # ---- the reference
    t_ref = time.perf_counter()
    ref = drv.check(conf, traffic, record, files.limits, seed, dev, root, workers)
    ref_s = time.perf_counter() - t_ref
    ctx.ref = ref

    units = {m["name"]: m["unit"] for m in files.spec["end_to_end"] + files.spec["per_layer"]}
    metrics = {}
    if trace:
        for m in files.per_layer:
            v = metric_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in files.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": units[m["name"]]}
    out = {
        "correct": ref["correct"],
        "attempted": n_work,
        "failed": 0,
        "metrics": metrics,
        "updates": n_work,
        "window_s": window,
        "settle_s": settle_s,
        "reference_s": ref_s,
        "compared": ref["compared"],
        "notes": ref.get("notes", []),
    }
    if trace and prof_out is not None and prof_out["busy_s"] > 0:
        out["busy_s"], out["traced_window_s"] = prof_out["busy_s"], prof_out["window_s"]
        top = sorted(prof_out["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
        out["breakdown"] = {"device_ops": [[short_name(k), v[0]] for k, v in top],
                            "idle_gaps": [[k, v] for k, v in prof_out["idle_gaps"]]}
    out["mem_peak"] = mem_peak
    return out


def short_name(kernel: str) -> str:
    """A kernel's name without its template arguments, with the functors and
    kernels named inside them: what tells two element-wise kernels apart."""
    import re

    kernel = kernel.replace("(anonymous namespace)::", "")
    base = kernel.replace("void ", "").split("<")[0].split("(")[0]
    inner = re.findall(r"(\w+(?:Functor|_kernel_impl|_kernel_cuda|Op|_kernel))\b", kernel[len(base):])
    tags = list(dict.fromkeys(t for t in inner if t != base.split("::")[-1]))[:3]
    return base + (f"[{','.join(tags)}]" if tags else "")
