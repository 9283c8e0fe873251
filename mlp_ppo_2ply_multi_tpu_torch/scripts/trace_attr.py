"""Stage attribution of one rollout step's device time and bytes.

Port of ``scripts/trace_attr.py``, with its arguments ``NAME`` (a
``scripts.bench_r2_sweep.variant_cfg`` name), ``B`` and ``TOP``. JAX joined
its profiler's per-fusion times with the compiled program's per-fusion
bytes and grouped both by the ``jax.named_scope`` path. Here the step runs
eagerly after one warm-up step, and two views of the same step are joined
by stage tag (``utils.profiling.stage_tag``: the JAX scope names on the
path, else the kernel's or op's name):

  1. ``utils.profiling.device_stage_times``: each device event of one
     profiled step under the scopes of the CPU op that launched it;
  2. ``utils.cost.step_cost``: each op's inputs and outputs in bytes.

It prints JAX's header, ``NAME B=...: device X ms, ~Y GB touched``, and
rows of ms, MB, device ops and tag, largest first; then the unscoped share
(device time under no stage) and the coverage: the attributed device ms
against the device ms of the same step captured as a CUDA graph, its
replays timed with CUDA events behind a spin kernel
(``utils.profiling.queued_ms_per_round``). The profiler drops records on
the card's machine, so nothing gates on the coverage.

The step attributed is the eager one: the graph replays the same kernels,
but the profiler links a replay's kernels to ``cudaGraphLaunch`` alone. The
eager step cannot be timed behind a spin kernel itself: its thousands of
launches fill the card's launch queue, and the host waits for room.

``--device cpu`` prints the bytes by stage alone (no device time). Without
a card and without ``--device cpu`` it raises.

Usage: python -m mlp_ppo_2ply_multi_tpu_torch.scripts.trace_attr \\
    [prod|twoply_tuned|...] [B] [TOP] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device
from mlp_ppo_2ply_multi_tpu_torch.core.graphs import capture_graph, capture_stream
from mlp_ppo_2ply_multi_tpu_torch.scripts.bench import card, setup
from mlp_ppo_2ply_multi_tpu_torch.scripts.bench_r2_sweep import variant_cfg
from mlp_ppo_2ply_multi_tpu_torch.utils import cost, profiling


def attribute(name: str, batch: int, device: DeviceLike = None) -> Dict[str, object]:
    """Both views of one eager step of variant ``name`` at ``batch`` games
    (seeded state, params and noise): ``stages`` {tag: (ms, device ops)}
    (``device_stage_times``; empty on the CPU, which has no device time),
    ``attributed_ms`` and ``traced_ms``; ``bytes`` {tag: bytes} and ``total_bytes``
    (``step_cost``); on a card also ``device_ms``, the device time of the
    step as a CUDA graph, its replays timed with CUDA events behind a spin
    kernel."""
    dev = resolve_device(device)
    cfg = variant_cfg(name)
    params, state, temp, gen = setup(cfg, batch, dev)
    # the noise drawn ahead: the step then never synchronises the host with
    # the card, so the host can queue it behind a spin kernel
    noise = actor.draw_noise(batch, cfg, gen, dev)

    def step():
        return actor.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)

    step()  # warm: device constants, the kernels' builds
    c = cost.step_cost(step)
    out = dict(stages={}, bytes={t: v["bytes"] for t, v in c.by_tag.items()},
               total_bytes=c.bytes)
    if dev.type == "cuda":
        st = profiling.device_stage_times(step)
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            step()  # the warm-up on the capture stream that capture_graph asks for
        graph, _, _ = capture_graph(step, dev, f"the {name} step")
        out.update(stages=st.stages, attributed_ms=st.attributed_ms, traced_ms=st.traced_ms,
                   device_ms=profiling.queued_ms_per_round([graph.replay], dev, rounds=4))
    return out


def _scoped(tag: str) -> bool:
    return all(profiling.STAGE_RE.fullmatch(p) for p in tag.split("/"))


def unscoped_ms(stages: Dict[str, tuple]) -> float:
    """Device ms under no stage: the rows whose tag is a kernel's name."""
    return sum(ms for tag, (ms, _) in stages.items() if not _scoped(tag))


def outer_stages(stages: Dict[str, tuple]) -> Dict[str, float]:
    """Device ms by outermost stage (a tag's first scope), and "unscoped",
    largest first."""
    out: Dict[str, float] = {}
    for tag, (ms, _) in stages.items():
        key = tag.split("/")[0] if _scoped(tag) else "unscoped"
        out[key] = out.get(key, 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def report(name: str, batch: int, top: int, a: Dict[str, object]) -> List[str]:
    """The printed table (module docstring) of ``attribute``'s result."""
    stages, nbytes = a["stages"], a["bytes"]
    gb = f"~{a['total_bytes'] / 1e9:.1f}GB touched (per-op inputs + outputs)"
    if not stages:
        lines = [f"{name} B={batch} on the CPU: {gb}; no device time",
                 "bytes by stage:"]
        lines += [f"{b / 1e6:9.1f}MB  {tag[:110]}" for tag, b in list(nbytes.items())[:top]]
        return lines
    lines = [f"{name} B={batch}: device {a['attributed_ms']:.1f}ms, {gb}"]
    for tag, (ms, n) in list(stages.items())[:top]:
        mb = f"{nbytes[tag] / 1e6:9.1f}MB" if tag in nbytes else f"{'-':>9s}MB"
        lines.append(f"{ms:7.2f}ms {mb} {n:4d}x  {tag[:110]}")
    outer = ", ".join(f"{k} {ms:.3f}" for k, ms in outer_stages(stages).items())
    lines.append(f"by outermost stage, ms: {outer}")
    un = unscoped_ms(stages)
    share = un / a["attributed_ms"] if a["attributed_ms"] else 0.0
    lines.append(f"unscoped: {un:.3f} ms of {a['attributed_ms']:.3f} ms attributed "
                 f"(share {share:.3f})")
    lines.append(f"coverage: profiled {a['traced_ms']:.3f} ms of device events, "
                 f"{a['attributed_ms']:.3f} ms attributed to a launching op, against "
                 f"{a['device_ms']:.3f} ms of device time for the step as a CUDA graph, "
                 f"timed with CUDA events ({a['attributed_ms'] / a['device_ms']:.3f})")
    lines.append("note: this attributes the eager step; the CUDA graph of the step "
                 "replays the same kernels, and the profiler links a replay's kernels "
                 "to cudaGraphLaunch alone")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("name", nargs="?", default="prod")
    ap.add_argument("batch", nargs="?", type=int, default=None)
    ap.add_argument("top", nargs="?", type=int, default=40)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = args.batch or (1024 if args.name.startswith("twoply") else 4096)
    a = attribute(args.name, batch, dev)
    print(f"device: {card(dev)}")
    for line in report(args.name, batch, args.top, a):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
