#!/usr/bin/env python3
"""Drive the PyTorch port's two self-play paths, its training loop, its
evaluation and play CLIs and the row-take probe on one CUDA card and check
them.

Run from the repository root, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Path 1 is the 1-ply production self-play step
(``mlp_ppo_2ply_multi_tpu_torch.actor.rollout.rollout_step`` under
``Config.production()``: split planes, two-tier candidate evaluation through
the fused board -> value CUDA kernel, bf16 value net) at B = 4096 games.
Path 2 is the 2-ply step under ``Config.production_twoply()`` with
``movegen.nd_tail_kernel=True`` at B = 1024: merged legal moves, the top-4
candidates reranked by the expected opponent reply, whose 15 non-double
reply enumerations run the fused non-doubles tail CUDA kernel and whose 22
value batches run the fused board -> value kernel. Both in continuous mode,
td_mode "side0", with the in-repo checkpoint's weights. Paths 3-5 train
through the CLI's own entry point, ``apps.train.main``, from random weights
made from a seed: continuous 1-ply, continuous 2-ply and sync with one Adam
step per episode. Path 6 is the row-take probe (``scripts.probe_take``), the
port of the TPU probe kernels P1-P3. Path 7 is the evaluate CLI's matches
(``eval.arena.play_match`` as replayed CUDA graphs at ``Config()``, 1024
games, 400 steps), whose merged legal moves run nd_tail at K = 576; path 8
the play CLI at batch 1; path 9 the trajectory-parity games
(``scripts.trajectory_parity``) through the sorted engine, whose row takes
run the redesigned take_rows. Phases, in order; any failure exits non-zero:

1. device: torch's view of the card and nvidia-smi's name and power limit;
2. build: one nvcc per kernel source, started together (seconds,
   registers, spills, shared memory), and the tensor-core instructions
   (HMMA/HGMMA) in fused_value_kernel's SASS, which must not be 0;
3. kernel vs plain (1-ply): fused_value against ``fused_value_plain`` at
   the main path's two shapes, on random in-domain boards and on the real
   candidate boards of a production step;
4. main path (1-ply): warm-up, then timed production steps with the launch
   count read around them (two launches per step);
5. same step, kernel vs plain: one step from the same state and noise;
   decisions agree on >= 99.9% of rows and the integer state is identical
   on agreeing rows;
6. card vs CPU: one step at B = 256 on the card and through the port's CPU
   path (which the CPU tests hold against the JAX package) — bit-equal
   legal moves, identical integer state on agreeing rows;
7. where the time goes: per-stage host times and a torch.profiler window;
8. kernel timing and bound (1-ply shapes);
9. kernels vs plain (2-ply): the inputs of one 2-ply step's 15 nd_tail and
   22 fused_value calls, each kernel against its plain version (nd_tail
   bit-equal: keep, n_pre, pct, kpair everywhere, after at kept slots);
10. main path (2-ply): warm-up, then timed steps; exactly 15 nd_tail and 22
    fused_value launches a step, checkers conserved, values finite;
11. kernel vs no kernel (2-ply): one state, one noise, through the nd_tail
    kernel and through its plain version swapped in: identical decisions
    and state on every row;
12. card vs CPU (2-ply) at B = 32: merged legal moves bit-equal, decisions
    equal but near-ties, identical integer state on agreeing rows;
13. where the 2-ply time goes: per-stage host times and a torch.profiler
    window;
14. kernel timing and bound at the 2-ply shapes (with fused_value's design
    floors: the dense layer-1 product and the sigmoid's MUFU work), the
    yardstick ``dense_product_ms`` (torch.matmul of a pre-built bf16 r by G,
    which the port never calls);
15. learner, card vs CPU: one real [64, 4096] trajectory of the production
    step, one fused TD(0) update on it from the same state on the card and
    on the CPU (TF32 off): loss, grad norm, params and Adam moments within
    the CPU tests' tolerances, counters and integer metrics equal; the
    update's ms (CUDA events and wall) and rows/s;
16. train, 1-ply: ``apps.train.main`` with --production --mode continuous
    --td-mode side0 --batch-games 4096 --steps-per-update 64 --updates 4
    --checkpoint-every 1: 4 metrics lines with finite loss, exactly
    2 x 256 fused_value launches, the last checkpoint restored bitwise on
    the card (params, Adam, version 4, generator state), and fused_value
    against its plain version on the trained params (the packed-params
    cache followed the in-place updates); ms an update, env-steps/s while
    training, the learner's share, peak memory;
17. train, 2-ply: --two-ply --production, B = 1024, 8 steps an update, 2
    updates: exactly 15 nd_tail and 22 fused_value launches a step, finite
    loss;
18. train, sync: --mode sync --production --per-episode-updates, B = 256,
    1 update (one 300-step rollout, then 256 sequential Adam steps): one
    metrics line of finite values at episode count 256;
19. no sync: one eager 1-ply (B = 4096) and one 2-ply (B = 1024) step with
    the noise drawn ahead under ``torch.cuda.set_sync_debug_mode("error")``:
    no op of the step synchronises the host with the card;
20. graphed vs eager, 1-ply: ``rollout_chunked`` (64 steps, chunk 4: a
    CUDA graph of 4 steps, captured once, replayed) against ``rollout_loop``
    from the same state and generator seed: every integer and bool field of
    the trajectory and the final state bit-equal, max |dv| printed; again
    after one ``td.update`` of the same params tensors; 2 fused_value
    launches a step, counted by replay;
21. graphed vs eager, 2-ply: 8 steps at chunk 4, both kernels inside the
    graph, bit-equal; 22 fused_value and 15 nd_tail launches a step;
22. graphed times: ms a step and env-steps/s of replays at chunk 1, 4 and
    16 (1-ply) and 1 and 4 (2-ply), each with its capture + instantiate
    seconds, its memory pool's bytes, the device's busy ms a step and idle
    share (torch.profiler), the graph's device ms a step with its replays
    queued ahead of the card, and its launch gate;

23. take_rows (the probe kernels P1-P3 of
    ``scripts/probe_pallas_batched_dot.py`` as one CUDA gather) bit-equal to
    ``take_rows_plain`` and, on in-range indices, to ``torch.gather``: at
    the probe's shape (N = 4096, K = W = 128), N = 4099, the actor's tier-1
    take (K = 96 from W = 448, int64) and that shape with indices outside
    [0, W), and the sorted engine's four take shapes (K = 512 from W = 27,
    also with indices outside [0, W), 128 from 16, 288 from 128, 512 from
    288); kernel, torch.gather and plain ms, the bound and the kernel's
    branch (``take_rows.plan``); then the probe entry point
    (``scripts.probe_take``) in-process and as subprocesses in the modes
    batched (P1), fused (P2) and bdiag8 (P3): each exact, exit 0;
24. arena, card vs CPU: greedy vs greedy and random vs greedy at B = 32,
    64 steps, small widths, dice and noise from one numpy stream: the
    graphed match on the card gives the CPU's MatchResult;
25. graphed vs eager match at the evaluate CLI's defaults (``Config()``,
    B = 1024, 400 steps, chunk 16, the checkpoint's weights): greedy vs
    random and greedy vs greedy bit-equal to the eager step loop, checkers
    conserved, one nd_tail launch (K = 576) a match step counted by replay;
    ms a match step, games/s, idle share, capture seconds; nd_tail at
    K = 576 against its plain version, timed;
26. the evaluate CLI (``apps.evaluate.main``) on the card: vs random and
    vs greedy with no flag, vs 2-ply at the defaults with the checkpoint,
    and a 2-ply agent at 256 games; JAX's summary keys, finished > 0,
    nd_tail launches gated;
27. the play CLI with ``--engine torch`` on the card and ``--engine
    oracle`` in subprocesses, moves piped in: exit 0, the same agent moves;
28. the sorted reference-order engine (``movegen.legal_moves`` with
    ``MoveGenConfig(algo="sorted")``), whose row takes run take_rows: card
    vs CPU at B = 256 on states 4 canonical decisions off the opening
    (boards, valid, count bit-equal), one decision at B = 4096 with every
    synchronising op made to raise, its ms, peak memory and top device ops
    (torch.profiler); then the port's
    trajectory script (``scripts.trajectory_parity.run``) over the 4096
    games of ``artifacts/traj_jax_4096.jsonl`` on the card: 4096/4096 hashes
    equal, the transcript sha256 of ``artifacts/trajectory_parity.json``,
    its wall seconds, and exactly 8 take_rows launches a decision;

then the kernels line (launches summed over every path's timed run) and the
result line. Phases 4, 7, 10 and 13 time the eager step; the training runs
(16-18) go through the graphed rollouts, as ``apps.train`` does.

It imports torch, numpy and the port only. Without CUDA, or without the
port beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

B_PROD = 4096
B_SMALL = 256
WARMUP = 4
STEPS = 32
CKPT = ROOT / "checkpoints" / "side0_20480000.pth"
# kernel vs plain: max |dv| (same rounding points; an f32 summation order
# can move one hidden unit by one bf16 ulp, <= 2^-9, times |w2|)
KERNEL_TOL = 5e-3
AGREE_MIN = 0.999
# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# CUDA-core operations (integer and f32, outside the tensor cores): the data
# sheet's 67 TFLOP/s f32 rate, which bounds the nd_tail kernel's int work
CORE_OPS_PER_S = 67e12
# MUFU (ex2, rcp): 16 a clock per SM, 132 SMs at the 1,980 MHz boost clock
MUFU_OPS_PER_S = 16 * 132 * 1.98e9
KERNEL_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/fused_value.cu"
KERNEL_REPLACES = "mlp_ppo_2ply_multi_tpu/ops/fused_value.py:93"
ND_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/experimental/csrc/nd_tail.cu"
ND_REPLACES = "mlp_ppo_2ply_multi_tpu/experimental/nd_tail.py:137"
TAKE_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/take_rows.cu"
TAKE_REPLACES = ("scripts/probe_pallas_batched_dot.py:55 (P1 take_pallas), "
                 "scripts/probe_pallas_batched_dot.py:86 (P2 take_pallas_fused), "
                 "scripts/probe_pallas_batched_dot.py:214 (P3 take_bdiag)")
# the probe modes run on the probe's main path: one JAX mode of each of P1,
# P2 and P3
PROBE_MODES = ("batched", "fused", "bdiag8")
# phase 23: the sorted engine's takes at its default widths, (name, W, K)
SORTED_TAKES = (("sorted_nd_first", 27, 512), ("sorted_level2", 16, 128),
                ("sorted_level3", 128, 288), ("sorted_level4", 288, 512))
B_ARENA_SMALL = 32  # phase 24: card vs CPU at the small widths
ARENA_SMALL_STEPS = 64
B_EVAL = 1024  # the evaluate CLI's --games
EVAL_STEPS = 400  # and its --max-steps
EVAL_CHUNK = 16
B_EVAL_TWOPLY_AGENT = 256  # --agent-policy twoply, cut to bound the run's time
B_TWOPLY = 1024
B_TWOPLY_SMALL = 32
WARMUP_2PLY = 2
STEPS_2PLY = 8
ND_LAUNCHES_PER_STEP = 15  # the non-double reply rolls
FV_LAUNCHES_PER_STEP_2PLY = 22  # candidates + 15 + 6 reply rolls
LEARN_STEPS = 64  # the learner's trajectory: --steps-per-update 64 at B_PROD
# the CPU tests' learner tolerances (tests/test_torch_learner.py)
LEARN_RTOL, PARAM_ATOL, MOMENT_RTOL, MOMENT_FLOOR = 1e-5, 1e-6, 1e-4, 1e-6
TRAIN_1PLY = ["--production", "--mode", "continuous", "--td-mode", "side0",
              "--batch-games", str(B_PROD), "--steps-per-update", "64", "--updates", "4",
              "--checkpoint-every", "1"]
TRAIN_2PLY = ["--two-ply", "--production", "--mode", "continuous",
              "--batch-games", str(B_TWOPLY), "--steps-per-update", "8", "--updates", "2"]
TRAIN_SYNC = ["--mode", "sync", "--production", "--per-episode-updates",
              "--batch-games", "256", "--updates", "1"]
GRAPH_STEPS_1PLY = 64  # graphed 1-ply rollouts: 16 replays of a 4-step chunk
B_SORTED_SMALL = 256  # phase 28: the sorted engine, card vs CPU
B_SORTED = 4096  # and one decision timed, the trajectory's games
# the sorted engine's row takes a decision: 2 first-ply, 3 parent, 3 forced-shorter
SORTED_TAKES_PER_DECISION = 8
TRAJ_HASHES = ROOT / "artifacts" / "traj_jax_4096.jsonl"
TRAJ_PARITY = ROOT / "artifacts" / "trajectory_parity.json"


def log(*args) -> None:
    print(*args, flush=True)


def _port():
    """Import the port from this checkout (never an installed copy)."""
    sys.path.insert(0, str(ROOT))
    import mlp_ppo_2ply_multi_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError(f"port imported from {pkg.__file__}, not {ROOT}")
    from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
    from mlp_ppo_2ply_multi_tpu_torch.apps import train
    from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
    from mlp_ppo_2ply_multi_tpu_torch.engine import board, movegen2
    from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
    from mlp_ppo_2ply_multi_tpu_torch.io import checkpoint
    from mlp_ppo_2ply_multi_tpu_torch.learner import td
    from mlp_ppo_2ply_multi_tpu_torch.model import value_net
    from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value
    from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax
    from mlp_ppo_2ply_multi_tpu_torch.apps import evaluate
    from mlp_ppo_2ply_multi_tpu_torch.core import config as config_mod
    from mlp_ppo_2ply_multi_tpu_torch.core import graphs, tree
    from mlp_ppo_2ply_multi_tpu_torch.eval import arena
    from mlp_ppo_2ply_multi_tpu_torch.ops import take_rows
    from mlp_ppo_2ply_multi_tpu_torch.scripts import probe_take
    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen
    from mlp_ppo_2ply_multi_tpu_torch.scripts import trajectory_parity

    return dict(
        rollout=rollout, Config=Config, board=board,
        movegen2=movegen2, vec_env=vec_env, value_net=value_net,
        fv=fused_value, nd=nd_tail, X=expectimax, td=td, train=train, ckpt=checkpoint,
        take=take_rows, probe=probe_take, arena=arena, evaluate=evaluate, cfg=config_mod,
        graphs=graphs, tree=tree, movegen=movegen, traj=trajectory_parity,
    )


def production_config(P):
    """Config.production() with td_mode "side0", the mode the in-repo
    checkpoint was trained in (side-0 values; side 1 minimizes)."""
    cfg = P["Config"].production()
    return cfg.replace(train=dataclasses.replace(cfg.train, td_mode="side0"))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Swap:
    """Swap a module attribute for a while (a plain version or a capturing
    wrapper) and put the original back."""

    def __init__(self, mod, name, fn):
        self.mod, self.name, self.fn = mod, name, fn

    def __enter__(self):
        self.saved = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)


def _ValueFn(P, fn):
    """Swap the 1-ply actor's value function."""
    return _Swap(P["rollout"], "fused_value", fn)


def leaves(x, prefix=""):
    out = {}
    for k in x._fields:
        v = getattr(x, k)
        if hasattr(v, "_fields"):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def decisions(P, params, state, noise, cfg, value_fn=None):
    """The actions the step takes from ``state`` with ``noise``, and the
    SplitMoves they were taken over."""
    R = P["rollout"]
    sm = P["movegen2"].legal_moves_split(state.board, state.player, state.dice, cfg.movegen)
    side0 = cfg.train.td_mode == "side0"
    cand_flag = (1 - state.player) if side0 else state.player
    sgn = torch.where(state.player == 0, 1.0, -1.0) if side0 else None
    temp = torch.tensor(cfg.train.initial_temperature, device=state.player.device)
    fn = value_fn or R.fused_value
    with _ValueFn(P, fn):
        action, _, _ = R._select_action_split(
            params, sm, cand_flag, sgn, noise.gumbel_t1, noise.gumbel_t2, temp, cfg
        )
    return action, sm


def _to_cpu(x):
    """A NamedTuple of tensors (nested) copied to the CPU."""
    return type(x)(*(_to_cpu(v) if hasattr(v, "_fields") else v.cpu() for v in x))


def compare_steps(P, a, b, agree, what):
    """Integer leaves of two (state, transition) results equal on rows where
    the decisions agree; float leaves finite."""
    (sa, ta), (sb, tb) = a, b
    for name, x in {**leaves(sa, "state."), **leaves(ta, "t.")}.items():
        y = {**leaves(sb, "state."), **leaves(tb, "t.")}[name]
        x, y = x.cpu(), y.cpu()
        if x.is_floating_point():
            if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
                raise AssertionError(f"{what}: {name} not finite")
            if name == "t.value":
                continue  # the obs value does not go through the kernel
        if not torch.equal(x[agree.cpu()], y[agree.cpu()]):
            raise AssertionError(f"{what}: {name} differs on agreeing rows")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] torch: {name}, count {count}; nvidia-smi: {smi}")
    return name, count, smi


def sass_mma_count(so, kernel):
    """Tensor-core instructions (HMMA/HGMMA) in ``kernel``'s SASS in the
    library ``so``, by cuobjdump; None where the toolkit has no cuobjdump."""
    from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import nvcc

    tool = Path(nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and ("HMMA" in line or "HGMMA" in line):
            count += 1
    return count


def phase_build(P):
    """One nvcc per kernel source, all started together."""
    fv, nd = P["fv"], P["nd"]
    kernels = (fv.KERNEL, nd.KERNEL, P["take"].KERNEL)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.load(), kernels))
    log(f"[2 build] {len(kernels)} kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        info = k.build_info
        log(f"[2 build] {info.get('path')} cached={info.get('cached')} "
            f"nvcc_s={info.get('seconds', 0.0):.2f}")
        for line in str(info.get("ptxas", "")).splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
                log(f"[2 build] ptxas: {line.strip()}")
    log(f"[2 build] dynamic shared memory: fused_value {fv.KERNEL.lib.fused_value_smem()} B "
        f"a CTA; nd_tail {nd.KERNEL.lib.nd_tail_smem(96)} B a CTA at K = 96, "
        f"{nd.KERNEL.lib.nd_tail_smem(nd.MAX_K)} B at K = {nd.MAX_K}")
    mma = sass_mma_count(fv.KERNEL.build_info["path"], "fused_value_kernel")
    log(f"[2 build] tensor-core instructions (HMMA/HGMMA) in fused_value_kernel's SASS: "
        f"{'not measured (no cuobjdump)' if mma is None else mma}")
    if mma == 0:
        raise AssertionError("fused_value_kernel has no tensor-core instruction")


def capture_candidates(P, params, state, cfg, dev, gen):
    """Run one production step and keep the (boards, flag) of each
    fused_value call: the real candidate boards of the main path."""
    R = P["rollout"]
    real = R.fused_value
    seen = []

    def capture(boards, flag, prm):
        seen.append((boards.clone(), torch.broadcast_to(flag, boards.shape[:-1]).clone()))
        return real(boards, flag, prm)

    with _ValueFn(P, capture):
        state, _ = R.rollout_step(
            params, state, cfg.train.initial_temperature, cfg, True, gen=gen, device=dev
        )
    return state, seen


def phase_kernel_vs_plain(P, params, real_inputs, dev, gen, card, random_cases=True,
                          tag="[3 kernel vs plain]"):
    fv = P["fv"]
    cases = []
    for shape in ((B_PROD, 96), (256, 448)) if random_cases else ():
        boards = torch.randint(0, 16, (*shape, 52), generator=gen, device=dev).to(torch.int8)
        flag = torch.randint(0, 2, (shape[0], 1), generator=gen, device=dev)
        cases.append((f"random{list(shape)}", boards, flag))
    for i, (boards, flag) in enumerate(real_inputs):
        cases.append((f"step_call{i + 1}{list(boards.shape[:-1])}", boards, flag))
    worst = 0.0
    for name, boards, flag in cases:
        got = fv.fused_value(boards, flag, params)
        want = fv.fused_value_plain(boards, flag, params)
        _sync(dev)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"kernel output bad at {name}")
        d = (got - want).abs()
        mx, mean = float(d.max()), float(d.mean())
        worst = max(worst, mx)
        log(f"{tag} {name}: max|dv|={mx:.3e} mean|dv|={mean:.3e} "
            f"tol={KERNEL_TOL} {card}")
        if mx > KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with plain at {name}: {mx}")
    return worst


def phase_main_path(P, params, state, cfg, dev, gen, card):
    R, fv, Bd = P["rollout"], P["fv"], P["board"]
    temp = cfg.train.initial_temperature
    for _ in range(WARMUP):
        state, _ = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    fv.KERNEL.launches = 0
    t0 = time.perf_counter()
    ev0.record()
    ts = []
    for _ in range(STEPS):
        state, t = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
        ts.append(t)
    ev1.record()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = fv.KERNEL.launches
    dev_ms = ev0.elapsed_time(ev1)
    traj = R.Transition(*(torch.stack(xs) for xs in zip(*ts)))
    b = state.player.shape[0]
    ms_step = dev_ms / STEPS
    stats = {
        "batch": b,
        "steps": STEPS,
        "ms_per_step": ms_step,
        "env_steps_per_s": b * STEPS / (dev_ms / 1e3),
        "wall_env_steps_per_s": b * STEPS / wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "fused_value_launches": launches,
        "games_finished": int(traj.done.sum()),
        "mean_legal_moves": float(traj.num_moves[traj.recorded].float().mean()),
        "overflow_count": int(traj.overflow.sum()),
        "conservation_ok": bool(
            Bd.checker_conservation_ok(Bd.Board(traj.packed_board)).all()
            & Bd.checker_conservation_ok(state.board).all()
        ),
        "values_finite": bool(torch.isfinite(traj.value).all()),
        "card": card,
    }
    log(f"[4 main path] {json.dumps(stats)}")
    if launches != 2 * STEPS:
        raise AssertionError(f"fused_value launched {launches} times in {STEPS} steps")
    if not stats["conservation_ok"] or not stats["values_finite"]:
        raise AssertionError("main path produced invalid boards or values")
    return state, stats


def phase_same_step(P, params, state, cfg, dev, gen, card):
    R, fv = P["rollout"], P["fv"]
    b = state.player.shape[0]
    noise = R.draw_noise(b, cfg, gen, dev)
    a_k, sm = decisions(P, params, state, noise, cfg)
    a_p, _ = decisions(P, params, state, noise, cfg, fv.fused_value_plain)
    agree = a_k == a_p
    # rows with no legal move take no decision
    live = sm.count > 0
    n_dis = int((~agree & live).sum())
    temp = cfg.train.initial_temperature
    res_k = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    with _ValueFn(P, fv.fused_value_plain):
        res_p = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    compare_steps(P, res_k, res_p, agree | ~live, "kernel vs plain step")
    frac = 1.0 - n_dis / max(1, int(live.sum()))
    log(f"[5 same step] decisions {int(live.sum()) - n_dis}/{int(live.sum())} agree "
        f"({frac:.6f}), integer state identical on agreeing rows {card}")
    if frac < AGREE_MIN:
        raise AssertionError(f"kernel vs plain decision agreement {frac}")
    return frac, n_dis


def phase_card_vs_cpu(P, params, cfg, dev, gen, card):
    R, mg2, VE = P["rollout"], P["movegen2"], P["vec_env"]
    state = VE.reset(B_SMALL, gen, device=dev)
    for _ in range(6):  # away from the opening position
        state, _ = R.rollout_step(
            params, state, cfg.train.initial_temperature, cfg, True, gen=gen, device=dev
        )
    noise = R.draw_noise(B_SMALL, cfg, gen, dev)
    cpu = torch.device("cpu")
    state_c, noise_c = _to_cpu(state), _to_cpu(noise)
    params_c = {k: v.cpu() for k, v in params.items()}

    sm_g = mg2.legal_moves_split(state.board, state.player, state.dice, cfg.movegen)
    sm_c = mg2.legal_moves_split(state_c.board, state_c.player, state_c.dice, cfg.movegen)
    masks = {"nd_boards": "nd_keep", "ndw_boards": "ndw_keep", "dd_boards": "dd_valid"}
    for name in sm_c._fields:
        g, c = getattr(sm_g, name), getattr(sm_c, name)
        if name in masks:
            m = getattr(sm_c, masks[name])
            same = torch.equal(g.data.cpu()[m], c.data[m])
        else:
            same = torch.equal(g.cpu(), c)
        if not same:
            raise AssertionError(f"legal_moves_split differs card vs CPU: {name}")
    a_g, _ = decisions(P, params, state, noise, cfg)
    a_c, _ = decisions(P, params_c, state_c, noise_c, cfg)
    live = sm_c.count > 0
    agree = (a_g.cpu() == a_c) | ~live
    temp = cfg.train.initial_temperature
    res_g = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    res_c = R.rollout_step(params_c, state_c, temp, cfg, True, noise=noise_c, device=cpu)
    compare_steps(P, res_g, res_c, agree, "card vs CPU step")
    dv = float((res_g[1].value.cpu() - res_c[1].value).abs().max())
    n_dis = int((~agree).sum())
    log(f"[6 card vs cpu] B={B_SMALL}: legal_moves_split bit-equal; decisions "
        f"{int(live.sum()) - n_dis}/{int(live.sum())} agree; obs value max|dv|={dv:.3e} {card}")
    if n_dis > (1 - AGREE_MIN) * int(live.sum()) or dv > KERNEL_TOL:
        raise AssertionError("card and CPU paths disagree")


def stage_times(P, params, state, cfg, dev, gen, n, stages, inner, tag, card):
    """Per-stage host times of ``n`` real rollout steps. Each (label, module,
    name) of ``stages`` (the step's top-level calls) and ``inner`` (calls
    inside one of them) is swapped for a timed copy that synchronises the
    card before and after it; "other" is the step less its top-level
    stages."""
    ms = {label: 0.0 for label, _, _ in stages + inner}

    def timed(label, fn):
        def run(*args, **kwargs):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(dev)
            ms[label] += (time.perf_counter() - t0) * 1e3 / n
            return out
        return run

    step_ms = 0.0
    with contextlib.ExitStack() as swaps:
        for label, mod, name in stages + inner:
            swaps.enter_context(_Swap(mod, name, timed(label, getattr(mod, name))))
        for _ in range(n):
            _sync(dev)
            t0 = time.perf_counter()
            state, _ = P["rollout"].rollout_step(
                params, state, cfg.train.initial_temperature, cfg, True, gen=gen, device=dev
            )
            _sync(dev)
            step_ms += (time.perf_counter() - t0) * 1e3 / n
    ms["other"] = step_ms - sum(ms[label] for label, _, _ in stages)
    ms["step"] = step_ms
    log(f"{tag} per-stage ms/step over {n} steps (synchronised around each; "
        f"{', '.join(label for label, _, _ in inner)} inside a stage): "
        f"{json.dumps(ms)} {card}")
    return state


def phase_time_breakdown(P, params, state, cfg, dev, gen, step_ms, card):
    """Per-stage host times, and the device's busy share from a
    torch.profiler window."""
    R, VE = P["rollout"], P["vec_env"]
    stages = [
        ("noise", R, "draw_noise"), ("movegen", R, "legal_moves_split"),
        ("obs_value", P["value_net"], "forward"), ("select", R, "_select_action_split"),
        ("env", VE, "step_chosen"), ("reset", VE, "reset_where"),
    ]
    inner = [("fused_value", R, "fused_value")]
    state = stage_times(P, params, state, cfg, dev, gen, 8, stages, inner, "[7 time]", card)
    profile_steps(P, params, state, cfg, dev, gen, 4, step_ms, card, "[7 time]")


def _dev_t(e) -> float:
    """An event's own device time in us (the attribute's name differs
    between torch versions)."""
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def _device_events(prof):
    """The trace's device events (kernels, copies, sets), averaged by name.
    torch.profiler also gives each CPU op the device time of the kernels it
    launched, so a sum over every event counts an eager kernel twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def profile_steps(P, params, state, cfg, dev, gen, steps, step_ms, card, tag):
    """Device busy time, idle share and the top device ops of ``steps``
    steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    R = P["rollout"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = R.rollout_step(
                params, state, cfg.train.initial_temperature, cfg, True, gen=gen, device=dev
            )
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = _device_events(prof)
    dev_t = _dev_t
    busy_us = sum(dev_t(e) for e in ev)
    n_kern = sum(e.count for e in ev)
    if busy_us > 0:
        busy_ms = busy_us / steps / 1e3
        # the profiler slows the host, so the traced wall overstates the step;
        # the idle share of the untraced step uses the timed phase's ms/step
        log(f"{tag} profiler: device busy {busy_ms:.3f} ms/step of "
            f"{wall_us / steps / 1e3:.3f} ms/step traced wall (idle share "
            f"{1 - busy_us / wall_us:.3f}); of the untraced {step_ms:.3f} ms/step "
            f"(idle share {1 - busy_ms / step_ms:.3f}); "
            f"{n_kern / steps:.0f} device ops/step {card}")
        top = sorted(ev, key=dev_t, reverse=True)[:12]
        for e in top:
            log(f"{tag}   {dev_t(e) / steps / 1e3:8.3f} ms/step  x{e.count // steps:<4d} "
                f"{e.key[:90]}")
    else:
        log(f"{tag} profiler: device time not measured (no CUDA events)")


def _time_ms(fn, dev, iters=30):
    for _ in range(3):
        fn()
    _sync(dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    _sync(dev)
    return e0.elapsed_time(e1) / iters


def kernel_bound(boards, hidden=128):
    """Least time for fused_value on these rows: the bytes it must move
    (boards + per-row flag in, f32 out, params) over HBM bandwidth, and the
    bf16 products this data needs (the nonzero lanes of r times G, plus the
    head) over the bf16 peak. Also the floors of the kernel's design: the
    dense 208 x h layer-1 product over the bf16 peak, and the sigmoid's two
    MUFU operations (ex2, rcp) per hidden unit over the MUFU rate."""
    c = boards.reshape(-1, 52).to(torch.int32)
    rows = c.shape[0]
    nnz = int(c[:, :48].clamp(0, 4).sum()) + int((c[:, 48:] > 0).sum())
    ops = 2 * nnz * hidden + rows * 2 * hidden
    dense_ops = rows * (2 * 208 * hidden + 2 * hidden)
    nbytes = rows * (52 + 1 + 4) + 208 * hidden * 2 + hidden * (4 + 4 + 2) + 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return dict(
        rows=rows, nnz_lanes_per_row=nnz / rows, bytes=nbytes, ops=ops,
        dense_ops=dense_ops, bytes_ms=t_bytes, ops_ms=t_ops,
        dense_ops_ms=dense_ops / BF16_FLOP_PER_S * 1e3,
        sigmoid_ms=rows * hidden * 2 / MUFU_OPS_PER_S * 1e3,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def _queued_ms_per_round(fns, dev, rounds=10):
    """Device time per round of calling every fn once: CUDA events around
    ``rounds`` rounds that the host queued while a spin kernel held the
    card, so the events time the kernels back to back, whatever the host's
    launch rate (a loop timed with events alone measures the host where
    each launch is shorter than its Python wrapper). The spin grows until
    the card is still spinning when the host has queued the last launch;
    the run fails if it never is."""
    for f in fns:
        f()
    _sync(dev)
    cycles = 10**8  # ~50 ms at the H100's 1.98 GHz boost clock
    for _ in range(4):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(rounds):
            for f in fns:
                f()
        e1.record()
        queued_ahead = not e0.query()
        _sync(dev)
        if queued_ahead:
            return e0.elapsed_time(e1) / rounds
        cycles *= 8
    raise AssertionError("the host could not queue the timed launches ahead of the card")


def phase_kernel_timing(P, params, real_inputs, dev, card, tag="[8 kernel time]", iters=30):
    """Per main-path input, with CUDA events around a loop of calls: the
    kernel alone (launches on operands laid out once), the whole wrapper as
    the main path calls it (packed params from the cache), and the plain
    version; then the kernel's device time per step, its launches queued
    ahead of the card. The inputs stay in L2 between launches, as the main
    path's freshly gathered tensors do."""
    fv = P["fv"]
    per = []
    kernel_calls = []
    for boards, flag in real_inputs:
        ops = fv.kernel_operands(boards, flag, params)
        kernel_calls.append(functools.partial(fv.launch_kernel, *ops))
        kern = lambda: fv.launch_kernel(*ops)
        wrap = lambda: fv.fused_value(boards, flag, params)
        plain = lambda: fv.fused_value_plain(boards, flag, params)
        # plain, kernel, wrapper, wrapper, kernel, plain in one call on one card
        p1, k1, w1, w2, k2, p2 = (
            _time_ms(f, dev, iters) for f in (plain, kern, wrap, wrap, kern, plain)
        )
        bd = kernel_bound(boards)
        row = dict(shape=list(boards.shape[:-1]), events_ms=(k1 + k2) / 2,
                   wrapper_ms=(w1 + w2) / 2, plain_ms=(p1 + p2) / 2,
                   runs_ms=[p1, k1, w1, w2, k2, p2], **bd)
        per.append(row)
        log(f"{tag} {json.dumps(row)} {card}")
    step = _step_sums(per, _queued_ms_per_round(kernel_calls, dev))
    log(f"{tag} one step: {json.dumps(step)} {card}")
    return step


def _step_sums(per, device_ms):
    """One step's launches summed: the kernel's device time (launches
    queued ahead), the event-timed kernel, wrapper and plain loops, and the
    bound."""
    t_bytes = sum(r["bytes_ms"] for r in per)
    t_ops = sum(r["ops_ms"] for r in per)
    floors = {k: sum(r[k] for r in per) for k in ("dense_ops_ms", "sigmoid_ms") if k in per[0]}
    return dict(
        calls_per_step=len(per),
        **floors,
        ms=device_ms,
        events_ms=sum(r["events_ms"] for r in per),
        wrapper_ms=sum(r["wrapper_ms"] for r in per),
        plain_ms=sum(r["plain_ms"] for r in per),
        bound_ms=sum(r["bound_ms"] for r in per),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


# ---------------------------------------------------------------------------
# the 2-ply path
# ---------------------------------------------------------------------------


def twoply_config(P):
    """Config.production_twoply() with td_mode "side0", and
    ``nd_tail_kernel`` set as the JAX package would need it to take its
    kernel (the port takes its kernel whatever the flag says)."""
    cfg = P["Config"].production_twoply()
    return cfg.replace(
        movegen=dataclasses.replace(cfg.movegen, nd_tail_kernel=True),
        train=dataclasses.replace(cfg.train, td_mode="side0"),
    )


def twoply_steps(P, params, state, cfg, dev, gen, n):
    for _ in range(n):
        state, _ = P["rollout"].rollout_step(
            params, state, cfg.train.initial_temperature, cfg, True, gen=gen, device=dev
        )
    return state


def capture_twoply_inputs(P, params, state, cfg, dev, gen):
    """Run one 2-ply step and keep the arguments of each nd_tail_fused and
    fused_value call: the real inputs of the 2-ply path's kernels."""
    nd, X = P["nd"], P["X"]
    nd_real, fv_real = nd.nd_tail_fused, X.fused_value
    nd_seen, fv_seen = [], []

    def nd_capture(*args):
        nd_seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return nd_real(*args)

    def fv_capture(boards, flag, prm):
        fv_seen.append((boards.clone(), torch.broadcast_to(flag, boards.shape[:-1]).clone()))
        return fv_real(boards, flag, prm)

    with _Swap(nd, "nd_tail_fused", nd_capture), _Swap(X, "fused_value", fv_capture):
        state = twoply_steps(P, params, state, cfg, dev, gen, 1)
    return state, nd_seen, fv_seen


def phase_twoply_kernels_vs_plain(P, params, nd_seen, fv_seen, dev, gen, card):
    """Both kernels against their plain versions on one 2-ply step's real
    inputs. nd_tail must be bit-equal (after at kept slots); its max abs
    error is taken over every compared integer."""
    nd = P["nd"]
    worst = 0
    after_everywhere = True
    kept = rows = 0
    for args in nd_seen:
        got = nd.nd_tail_fused(*args)
        want = nd.nd_tail_plain(*args)
        _sync(dev)
        for name, a, b in zip(("after", "keep", "n_pre", "pct", "kpair"), got, want):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"nd_tail {name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        m = want[1]
        diffs = [(got[0][m].int() - want[0][m].int()).abs()]
        diffs += [(a.int() - b.int()).abs() for a, b in zip(got[1:], want[1:])]
        worst = max([worst] + [int(d.max()) for d in diffs if d.numel()])
        after_everywhere &= torch.equal(got[0], want[0])
        kept += int(m.sum())
        rows += m.shape[0]
    n_pre = torch.cat([a[0].sum(-1) for a in nd_seen])
    log(f"[9 kernels vs plain 2-ply] nd_tail: {len(nd_seen)} calls at "
        f"{list(nd_seen[0][0].shape[:1]) + [nd_seen[0][7]]} (K = a_max = {nd_seen[0][8]}), "
        f"{rows} rows, {kept} kept slots, n_pre mean {float(n_pre.float().mean()):.2f} "
        f"max {int(n_pre.max())}; max |diff| over keep/n_pre/pct/kpair and kept "
        f"afterstates = {worst}; after equal at every slot: {after_everywhere} {card}")
    if worst != 0:
        raise AssertionError("nd_tail kernel differs from its plain version")
    worst_fv = phase_kernel_vs_plain(P, params, fv_seen, dev, gen, card, random_cases=False,
                                     tag="[9 kernels vs plain 2-ply] fused_value")
    return float(worst), worst_fv


def phase_twoply_main(P, params, state, cfg, dev, gen, card):
    fv, nd, Bd = P["fv"], P["nd"], P["board"]
    R = P["rollout"]
    temp = cfg.train.initial_temperature
    state = twoply_steps(P, params, state, cfg, dev, gen, WARMUP_2PLY)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    fv.KERNEL.launches = 0
    nd.KERNEL.launches = 0
    t0 = time.perf_counter()
    ev0.record()
    ts = []
    for _ in range(STEPS_2PLY):
        state, t = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
        ts.append(t)
    ev1.record()
    _sync(dev)
    wall = time.perf_counter() - t0
    fv_launches, nd_launches = fv.KERNEL.launches, nd.KERNEL.launches
    dev_ms = ev0.elapsed_time(ev1)
    traj = R.Transition(*(torch.stack(xs) for xs in zip(*ts)))
    b = state.player.shape[0]
    stats = {
        "batch": b,
        "steps": STEPS_2PLY,
        "ms_per_step": dev_ms / STEPS_2PLY,
        "env_steps_per_s": b * STEPS_2PLY / (dev_ms / 1e3),
        "wall_env_steps_per_s": b * STEPS_2PLY / wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "fused_value_launches": fv_launches,
        "nd_tail_launches": nd_launches,
        "games_finished": int(traj.done.sum()),
        "mean_legal_moves": float(traj.num_moves[traj.recorded].float().mean()),
        "overflow_count": int(traj.overflow.sum()),
        "conservation_ok": bool(
            Bd.checker_conservation_ok(Bd.Board(traj.packed_board)).all()
            & Bd.checker_conservation_ok(state.board).all()
        ),
        "values_finite": bool(torch.isfinite(traj.value).all()),
        "card": card,
    }
    log(f"[10 main path 2-ply] {json.dumps(stats)}")
    if nd_launches != ND_LAUNCHES_PER_STEP * STEPS_2PLY:
        raise AssertionError(f"nd_tail launched {nd_launches} times in {STEPS_2PLY} steps")
    if fv_launches != FV_LAUNCHES_PER_STEP_2PLY * STEPS_2PLY:
        raise AssertionError(f"fused_value launched {fv_launches} times in {STEPS_2PLY} steps")
    if not stats["conservation_ok"] or not stats["values_finite"]:
        raise AssertionError("2-ply path produced invalid boards or values")
    return state, stats


def decisions_2ply(P, params, state, noise, cfg):
    """The actions the 2-ply step takes from ``state`` with ``noise``, and
    the merged legal moves they were taken over."""
    moves = P["movegen2"].legal_moves(state.board, state.player, state.dice, cfg.movegen)
    temp = torch.tensor(cfg.train.initial_temperature, device=state.player.device)
    action, _ = P["X"].select_action_2ply(
        params, state, moves, noise.gumbel_2ply, noise.gumbel_1ply, temp, cfg
    )
    return action, moves


def phase_twoply_kernel_vs_no_kernel(P, params, state, cfg, dev, gen, card):
    """One state and one noise through the 2-ply step with the nd_tail kernel
    and with its plain version swapped in: B2 is exact, so every decision,
    every state leaf and every transition leaf must be identical."""
    R, nd = P["rollout"], P["nd"]
    b = state.player.shape[0]
    noise = R.draw_noise(b, cfg, gen, dev)
    temp = cfg.train.initial_temperature
    a_k, _ = decisions_2ply(P, params, state, noise, cfg)
    res_k = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    n0 = nd.KERNEL.launches
    with _Swap(nd, "nd_tail_fused", nd.nd_tail_plain):
        a_p, _ = decisions_2ply(P, params, state, noise, cfg)
        res_p = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    if nd.KERNEL.launches != n0:
        raise AssertionError("the no-kernel step launched the nd_tail kernel")
    (sk, tk), (sp, tp) = res_k, res_p
    lk = {**leaves(sk, "state."), **leaves(tk, "t.")}
    lp = {**leaves(sp, "state."), **leaves(tp, "t.")}
    differ = [k for k in lk if not torch.equal(lk[k], lp[k])]
    n_same = int((a_k == a_p).sum())
    log(f"[11 kernel vs no kernel 2-ply] B={b}: decisions {n_same}/{b} identical; "
        f"state and transition leaves differing: {differ or 'none'} {card}")
    if n_same != b or differ:
        raise AssertionError("2-ply step differs with and without the nd_tail kernel")


def phase_twoply_card_vs_cpu(P, params, cfg, dev, gen, card):
    R, VE = P["rollout"], P["vec_env"]
    state = VE.reset(B_TWOPLY_SMALL, gen, device=dev)
    state = twoply_steps(P, params, state, cfg, dev, gen, 4)
    noise = R.draw_noise(B_TWOPLY_SMALL, cfg, gen, dev)
    cpu = torch.device("cpu")
    state_c, noise_c = _to_cpu(state), _to_cpu(noise)
    params_c = {k: v.cpu() for k, v in params.items()}

    a_g, m_g = decisions_2ply(P, params, state, noise, cfg)
    a_c, m_c = decisions_2ply(P, params_c, state_c, noise_c, cfg)
    for f in ("valid", "count", "overflow"):
        if not torch.equal(getattr(m_g, f).cpu(), getattr(m_c, f)):
            raise AssertionError(f"2-ply legal_moves differs card vs CPU: {f}")
    if not torch.equal(m_g.boards.data.cpu()[m_c.valid], m_c.boards.data[m_c.valid]):
        raise AssertionError("2-ply legal_moves boards differ card vs CPU")
    live = m_c.count > 0
    agree = (a_g.cpu() == a_c) | ~live
    temp = cfg.train.initial_temperature
    gaps = []
    if not agree.all():  # in the CPU path's own scores
        s = P["X"].sampled_logits_2ply(
            params_c, state_c, m_c, noise_c.gumbel_2ply, noise_c.gumbel_1ply,
            torch.tensor(temp), cfg,
        )
        gaps = [P["X"].sampled_gap(s, int(r), int(a_g[r]), int(a_c[r]))
                for r in torch.nonzero(~agree)[:, 0]]
    res_g = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    res_c = R.rollout_step(params_c, state_c, temp, cfg, True, noise=noise_c, device=cpu)
    compare_steps(P, res_g, res_c, agree, "2-ply card vs CPU step")
    log(f"[12 card vs cpu 2-ply] B={B_TWOPLY_SMALL}: legal_moves bit-equal; decisions "
        f"{int(agree.sum())}/{B_TWOPLY_SMALL} agree; near-tie gaps of the others {gaps} {card}")
    if any(g > 2 * KERNEL_TOL / temp for g in gaps):
        raise AssertionError(f"2-ply card and CPU decisions disagree beyond a near-tie: {gaps}")


def nd_tail_child_rows(valid, K):
    """Per row, the distinct 52-byte child rows of the pass-A and pass-B
    tables (27 each) that nd_tail must read: those of the first min(count,
    K) set cells, and pass B's child 26 where the count is under K (the
    clip slot). Cell c lies in block c // 27 (pass-A pairs 0..26, singles
    27, pass-B pairs 28..54, singles 55); a pair takes the child of its
    block, a single the child of its place in the block."""
    c = torch.arange(1512, device=valid.device)
    blk, loc = c // 27, c % 27
    cpass = (blk >= 28).long()
    bb = blk - 28 * cpass
    child = 27 * cpass + torch.where(bb < 27, bb, loc)  # 0..53
    onehot = torch.nn.functional.one_hot(child, 54).float()
    sel = valid & (torch.cumsum(valid.int(), -1) <= K)
    used = (sel.float() @ onehot) > 0
    used[:, 53] |= valid.sum(-1) < K
    return used.sum(-1)


def nd_tail_bound(valid, K):
    """Least time for nd_tail on these rows: the bytes it must move (1512
    candidate bytes, the child rows its selected candidates use,
    ``nd_tail_child_rows``, the 52-byte root and three int32 in; K x 52
    afterstates, keep and kpair bytes and two int32 out) over HBM
    bandwidth, and the operations this data needs over the CUDA-core rate:
    every candidate bit is read by the select, and each present candidate
    (at most K) is decoded, applied and signed (counted as 64 operations)
    and compared with the earlier ones."""
    n = valid.shape[0]
    m = valid.sum(-1).clamp_max(K).to(torch.int64)
    children = int(nd_tail_child_rows(valid, K).sum())
    nbytes = n * (1512 + 52 + 3 * 4) + 52 * children + n * (K * 52 + 2 * K + 2 * 4)
    ops = n * 1512 + int((64 * m + m * (m - 1) // 2).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return dict(
        rows=n, K=K, present_per_row=float(m.float().mean()),
        child_rows_per_row=children / n, bytes=nbytes, ops=ops,
        bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def phase_twoply_kernel_timing(P, params, nd_seen, fv_seen, dev, card):
    """nd_tail per captured call: the kernel alone, the wrapper (operand
    layout + launch) and the plain version; fused_value at the 2-ply
    shapes likewise. Each summed over one step's launches."""
    nd = P["nd"]
    per = []
    kernel_calls = []
    for args in nd_seen:
        K, a_max = args[7], args[8]
        ops = nd.kernel_operands(*args[:7], K)
        kernel_calls.append(functools.partial(nd.launch_kernel, *ops, K, a_max))
        kern = kernel_calls[-1]
        wrap = lambda: nd.nd_tail_fused(*args)
        plain = lambda: nd.nd_tail_plain(*args)
        p1, k1, w1, w2, k2, p2 = (
            _time_ms(f, dev, 10) for f in (plain, kern, wrap, wrap, kern, plain)
        )
        per.append(dict(events_ms=(k1 + k2) / 2, wrapper_ms=(w1 + w2) / 2,
                        plain_ms=(p1 + p2) / 2, runs_ms=[p1, k1, w1, w2, k2, p2],
                        **nd_tail_bound(args[0], K)))
    nd_step = _step_sums(per, _queued_ms_per_round(kernel_calls, dev))
    log(f"[14 kernel time 2-ply] nd_tail per launch: "
        f"{json.dumps({k: per[0][k] for k in ('rows', 'K', 'present_per_row', 'child_rows_per_row', 'bytes', 'ops', 'bytes_ms', 'ops_ms', 'bound_ms')})}; "
        f"event-timed loop ms per call {[round(r['events_ms'], 4) for r in per]} {card}")
    log(f"[14 kernel time 2-ply] nd_tail one step: {json.dumps(nd_step)} {card}")
    fv_step = phase_kernel_timing(P, params, fv_seen, dev, card, "[14 kernel time 2-ply] fused_value", 10)
    fv_step["dense_product_ms"] = dense_product_ms(P, params, fv_seen[1][0], dev, card)
    return nd_step, fv_step


def dense_product_ms(P, params, boards, dev, card):
    """A yardstick, not the same function: torch.matmul of a pre-built bf16
    r [rows, 208] by G [208, 128] at one reply call's rows, by CUDA events.
    The port never calls it."""
    g = P["fv"].recombine_params(params)[0]
    c = boards.reshape(-1, 52).float()
    r = torch.clamp(c[:, :, None] - torch.arange(4.0, device=dev), min=0)
    r = r.reshape(-1, 208).to(torch.bfloat16)
    ms = _time_ms(lambda: torch.matmul(r, g), dev, 20)
    log(f"[14 kernel time 2-ply] dense_product_ms (torch.matmul bf16 "
        f"{list(r.shape)} x {list(g.shape)}): {ms:.4f} {card}")
    return ms


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


def _clone_state(P, state, dev):
    return P["td"].map_state(lambda t: t.detach().to(dev, copy=True), state)


def compare_learner(a, b, what):
    """Two (state, metrics) results of one update, held to the CPU tests'
    tolerances (tests/test_torch_learner.py). Returns the largest errors."""
    (sa, ma), (sb, mb) = a, b
    err = {}
    for k in ("loss", "grad_norm", "td_abs", "v_mean"):
        x, y = float(ma[k]), float(mb[k])
        err[f"{k}_rel"] = abs(x - y) / max(abs(y), 1e-30)
        if err[f"{k}_rel"] > LEARN_RTOL:
            raise AssertionError(f"{what}: {k} {x} vs {y}")
    for k in ("wins_regular", "wins_gammon", "wins_backgammon", "close_out_count",
              "prime_count", "width_overflow_count"):
        if int(ma[k]) != int(mb[k]):
            raise AssertionError(f"{what}: {k} {int(ma[k])} vs {int(mb[k])}")
    for k in ("version", "episode_count"):
        if int(getattr(sa, k)) != int(getattr(sb, k)):
            raise AssertionError(f"{what}: {k} differs")
    if int(sa.opt_state.count) != int(sb.opt_state.count):
        raise AssertionError(f"{what}: Adam count differs")
    err["params_abs"] = max(float((sa.params[k].cpu() - sb.params[k].cpu()).abs().max())
                            for k in sb.params)
    if err["params_abs"] > PARAM_ATOL:
        raise AssertionError(f"{what}: params differ by {err['params_abs']}")
    for name in ("mu", "nu"):
        worst = 0.0
        for k in sb.params:
            x = getattr(sa.opt_state, name)[k].cpu()
            y = getattr(sb.opt_state, name)[k].cpu()
            lim = MOMENT_RTOL * y.abs() + MOMENT_FLOOR * float(y.abs().max())
            if not bool(((x - y).abs() <= lim).all()):
                raise AssertionError(f"{what}: Adam {name} {k} differs")
            worst = max(worst, float(((x - y).abs() / y.abs().clamp_min(1e-30)).max()))
        err[f"{name}_rel"] = worst
    return err


def phase_learner(P, dev, gen, card):
    """One fused update on one real [64, 4096] production trajectory, from
    the same state on the card and on the CPU."""
    R, td = P["rollout"], P["td"]
    cfg = production_config(P)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, per_episode_updates=False))
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    state = P["vec_env"].reset(B_PROD, gen, device=dev)
    _, traj = R.rollout_loop(params, state, cfg.train.initial_temperature, cfg, LEARN_STEPS,
                             continuous=True, gen=gen, device=dev)
    # one update first, so the compared one starts from non-zero moments
    start = td.init_train_state(cfg, gen, dev)._replace(
        params=params, opt_state=td.init_adam(params))
    start, _ = td.update(start, traj, cfg, dev)
    events, walls = [], []
    for _ in range(3):
        s = _clone_state(P, start, dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _sync(dev)
        t0 = time.perf_counter()
        e0.record()
        card_out = td.update(s, traj, cfg, dev)
        e1.record()
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(e0.elapsed_time(e1))
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu_out = td.update(_clone_state(P, start, cpu), _to_cpu(traj), cfg, cpu)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = compare_learner(card_out, cpu_out, "learner card vs CPU")
    rows = traj.reward.numel()
    ms = sorted(events)[1]
    stats = dict(rows=rows, ms_per_update=ms, wall_ms_per_update=sorted(walls)[1],
                 runs_ms=events, rows_per_s=rows / (ms / 1e3), cpu_ms=cpu_ms,
                 loss=float(card_out[1]["loss"]), **err)
    log(f"[15 learner card vs cpu] {json.dumps(stats)} {card}")
    return stats


def run_train(P, flags, dev, tag, card):
    """``apps.train.main(flags)`` in-process, in a temp dir, with every
    kernel count set to 0 just before it and read just after; each
    update's rollout (the graphed ``rollout`` in sync mode, else
    ``rollout_chunked``; the first one captures its graph) and td.update
    are timed (synchronised around each) and the final checkpoint's state
    and generator are kept."""
    td, fv, nd, R = P["td"], P["fv"], P["nd"], P["rollout"]
    rollout_fn = "rollout" if "sync" in flags else "rollout_chunked"
    learn_ms, roll_ms, saved = [], [], {}
    real_save = P["ckpt"].save

    def timed(fn, into):
        def run(*args, **kwargs):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(dev)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def keep_save(directory, state, generator, *args, **kwargs):
        step = real_save(directory, state, generator, *args, **kwargs)
        saved.update(live=state, state=_clone_state(P, state, dev), dir=directory,
                     gen=generator.get_state(), step=step)
        return step

    with tempfile.TemporaryDirectory() as tmp:
        argv = flags + ["--device", "cuda", "--checkpoint-dir", f"{tmp}/ck",
                        "--metrics-dir", f"{tmp}/runs", "--log-every", "1"]
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with _Swap(td, "update", timed(td.update, learn_ms)), \
                _Swap(R, rollout_fn, timed(getattr(R, rollout_fn), roll_ms)), \
                _Swap(P["ckpt"], "save", keep_save):
            fv.KERNEL.launches = 0
            nd.KERNEL.launches = 0
            t0 = time.perf_counter()
            rc = P["train"].main(argv)
            _sync(dev)
            wall = time.perf_counter() - t0
            launches = {"fused_value": fv.KERNEL.launches, "nd_tail": nd.KERNEL.launches}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        (run,) = Path(tmp, "runs").iterdir()
        recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        lines = [r for r in recs if "hist" not in r]
        restored = P["ckpt"].restore(saved["dir"], dev)
    if rc != 0:
        raise AssertionError(f"{tag} train.main returned {rc}")
    n = len(lines)
    per_update = (lines[-1]["t"] - lines[0]["t"]) / (n - 1) * 1e3 if n > 1 else None
    stats = dict(
        rc=rc, updates=n, wall_s=wall, launches=launches,
        ms_per_update=per_update,
        learner_ms=learn_ms, rollout_ms=roll_ms,
        run_env_steps_per_s=lines[-1]["env_steps_per_sec"],
        loss=[r["loss"] for r in lines], peak_mem_gib=peak,
        episode_count=lines[-1]["step"], card=card,
    )
    return stats, lines, saved, restored


def _states_equal(P, a, b):
    fa, fb = [], []
    P["td"].map_state(fa.append, a)
    P["td"].map_state(fb.append, b)
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(fa, fb))


def update_breakdown(stats, steps_per_update):
    """Where a steady update's time goes (the updates after the first): the
    rollout, the learner, and the rest of the loop (the metrics pull and
    write, histograms, checkpoints), each in ms, from the synchronised
    timers and the metrics lines' clock."""
    ms = stats["ms_per_update"]
    roll = sum(stats["rollout_ms"][1:]) / (len(stats["rollout_ms"]) - 1)
    learn = sum(stats["learner_ms"][1:]) / (len(stats["learner_ms"]) - 1)
    return dict(rollout_ms_mean=roll, rollout_ms_per_step=roll / steps_per_update,
                learner_ms_mean=learn, other_ms_mean=ms - roll - learn,
                learner_share=learn / ms)


def bare_steps_ms(P, params, cfg, batch, dev, gen, n=8):
    """ms a step of the same step outside the training loop, in the same
    process just after it: 2 warm-up steps, then ``n`` timed with a host
    clock around a synchronised loop."""
    R = P["rollout"]
    state = P["vec_env"].reset(batch, gen, device=dev)
    for _ in range(2):
        state, _ = R.rollout_step(params, state, 1.0, cfg, True, gen=gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = R.rollout_step(params, state, 1.0, cfg, True, gen=gen, device=dev)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def phase_train_1ply(P, dev, gen, card):
    stats, lines, saved, (restored, gen_state, step) = run_train(
        P, TRAIN_1PLY, dev, "[16 train 1-ply]", card)
    steps = 64 * stats["updates"]
    if stats["updates"] != 4 or not all(math.isfinite(x) for x in stats["loss"]):
        raise AssertionError(f"[16 train 1-ply] metrics lines: {stats['updates']}, {stats['loss']}")
    if stats["launches"]["fused_value"] != 2 * steps:
        raise AssertionError(f"[16 train 1-ply] fused_value launched {stats['launches']}")
    bitwise = (_states_equal(P, restored, saved["state"]) and int(restored.version) == 4
               and torch.equal(gen_state, saved["gen"]) and step == saved["step"])
    if not bitwise:
        raise AssertionError("[16 train 1-ply] the last checkpoint does not restore bitwise")
    # the trained params are the tensors the updates changed in place: the
    # kernel reads them through the packed-params cache
    trained = saved["live"].params
    boards = torch.randint(0, 16, (B_PROD, 96, 52), generator=gen, device=dev).to(torch.int8)
    flag = torch.randint(0, 2, (B_PROD, 1), generator=gen, device=dev)
    fv = P["fv"]
    got = fv.fused_value(boards, flag, trained)
    want = fv.fused_value_plain(boards, flag, trained)
    cfg = production_config(P)
    first = P["td"].init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    moved = float((fv.fused_value_plain(boards, flag, first.params) - want).abs().max())
    dv = float((got - want).abs().max())
    stats.update(
        env_steps_per_s=B_PROD * 64 / (stats["ms_per_update"] / 1e3),
        **update_breakdown(stats, 64),
        bare_step_ms=bare_steps_ms(P, trained, cfg, B_PROD, dev, gen),
        checkpoint_bitwise=bitwise,
        trained_kernel_max_abs_err=dv, trained_vs_initial_plain_max_abs=moved,
    )
    log(f"[16 train 1-ply] {json.dumps(stats)}")
    if dv > KERNEL_TOL:
        raise AssertionError(f"[16 train 1-ply] fused_value on trained params off by {dv}")
    return stats


def phase_train_2ply(P, dev, card):
    stats, lines, _, _ = run_train(P, TRAIN_2PLY, dev, "[17 train 2-ply]", card)
    steps = 8 * stats["updates"]
    stats.update(env_steps_per_s=B_TWOPLY * 8 / (stats["ms_per_update"] / 1e3),
                 **update_breakdown(stats, 8))
    log(f"[17 train 2-ply] {json.dumps(stats)}")
    want = {"fused_value": FV_LAUNCHES_PER_STEP_2PLY * steps,
            "nd_tail": ND_LAUNCHES_PER_STEP * steps}
    if stats["updates"] != 2 or stats["launches"] != want:
        raise AssertionError(f"[17 train 2-ply] {stats['updates']} updates, launches "
                             f"{stats['launches']}, want {want}")
    if not all(math.isfinite(x) for x in stats["loss"]):
        raise AssertionError("[17 train 2-ply] loss not finite")
    return stats


def phase_train_sync(P, dev, card):
    stats, lines, _, _ = run_train(P, TRAIN_SYNC, dev, "[18 train sync]", card)
    log(f"[18 train sync] {json.dumps(stats)}; metrics line {json.dumps(lines[0])}")
    finite = all(math.isfinite(v) for v in lines[0].values())
    if stats["updates"] != 1 or not finite or stats["episode_count"] != 256:
        raise AssertionError("[18 train sync] bad metrics line")
    if stats["launches"]["fused_value"] != 2 * 300:
        raise AssertionError(f"[18 train sync] fused_value launched {stats['launches']}")
    return stats


# ---------------------------------------------------------------------------
# the graphed rollouts
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def syncs_raise(dev):
    """Make any op that synchronises the host with the card raise."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_no_sync(P, params, cfgs, dev, gen, card):
    """One eager step of each path (1-ply B = 4096, 2-ply B = 1024) with its
    noise drawn ahead, a Python-float temperature and every synchronising
    op made to raise."""
    R, VE = P["rollout"], P["vec_env"]
    for name, cfg, batch in cfgs:
        state = VE.reset(batch, gen, device=dev)
        state, _ = R.rollout_step(params, state, 1.0, cfg, True, gen=gen, device=dev)
        noise = R.draw_noise(batch, cfg, gen, dev)
        _sync(dev)
        with syncs_raise(dev):
            state, t = R.rollout_step(params, state, 1.0, cfg, True, noise=noise, device=dev)
        _sync(dev)
        log(f"[19 no sync] {name} step at B={batch}: no op synchronised the host with the "
            f"card (torch.cuda.set_sync_debug_mode('error')); {int(t.recorded.sum())} "
            f"decisions {card}")


def compare_rollouts(eager, graphed, what):
    """Every integer and bool leaf of two (state, trajectory) results
    bit-equal; returns the largest |dv| of the float leaves."""
    a = {**leaves(eager[0], "state."), **leaves(eager[1], "t.")}
    b = {**leaves(graphed[0], "state."), **leaves(graphed[1], "t.")}
    dv = 0.0
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what}: {k} {x.dtype}{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}")
        if x.is_floating_point():
            if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
                raise AssertionError(f"{what}: {k} not finite")
            dv = max(dv, float((x - y).abs().max()))
        elif not torch.equal(x, y):
            raise AssertionError(f"{what}: {k} differs")
    return dv


def eager_and_graphed(P, params, cfg, batch, steps, chunk, seed, dev):
    """``rollout_loop`` and ``rollout_chunked`` from one state and one
    generator seed; the graphed run's launches of each kernel, counted from
    0 just before it and read just after."""
    R, VE, fv, nd = P["rollout"], P["vec_env"], P["fv"], P["nd"]
    temp = cfg.train.initial_temperature
    out = []
    for graphed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = VE.reset(batch, gen, device=dev)
        fv.KERNEL.launches = nd.KERNEL.launches = 0
        if graphed:
            out.append(R.rollout_chunked(params, state, temp, cfg, steps, chunk=chunk,
                                         gen=gen, device=dev))
        else:
            out.append(R.rollout_loop(params, state, temp, cfg, steps, True, gen=gen,
                                      device=dev))
        _sync(dev)
    return out[0], out[1], {"fused_value": fv.KERNEL.launches, "nd_tail": nd.KERNEL.launches}


def _gate(launches, want, what):
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def phase_graph_vs_eager_1ply(P, dev, card):
    """The production 1-ply rollout graphed (64 steps, chunk 4) against the
    eager loop from the same state and seed, then again after one td.update
    of the same params tensors (the graph must read the new weights)."""
    R, td = P["rollout"], P["td"]
    cfg = production_config(P)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, per_episode_updates=False))
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    steps, chunk = GRAPH_STEPS_1PLY, 4
    eager, graphed, launches = eager_and_graphed(P, params, cfg, B_PROD, steps, chunk, 11, dev)
    dv = compare_rollouts(eager, graphed, "graphed vs eager 1-ply")
    _gate(launches["fused_value"], 2 * steps, "graphed 1-ply fused_value")
    start = td.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)._replace(
        params=params, opt_state=td.init_adam(params))
    trained, metrics = td.update(start, graphed[1], cfg, dev)
    if trained.params["w1"] is not params["w1"]:
        raise AssertionError("td.update did not update the params in place")
    eager2, graphed2, launches2 = eager_and_graphed(P, params, cfg, B_PROD, steps, chunk, 12, dev)
    dv2 = compare_rollouts(eager2, graphed2, "graphed vs eager 1-ply after an update")
    _gate(launches2["fused_value"], 2 * steps, "graphed 1-ply fused_value after an update")
    # the update moved the values, so a graph still reading the old packed
    # G would have taken other decisions
    boards, flag = eager2[1].packed_board[0], 1 - eager2[1].player[0]
    before = P["fv"].fused_value_plain(
        boards, flag, P["value_net"].load_checkpoint(str(CKPT), device=dev))
    moved = float((P["fv"].fused_value_plain(boards, flag, params) - before).abs().max())
    stats = dict(batch=B_PROD, steps=steps, chunk=chunk, launches=launches["fused_value"],
                 launches_after_update=launches2["fused_value"], max_abs_dv=dv,
                 after_update_max_abs_dv=dv2, loss=float(metrics["loss"]),
                 values_moved_by_update=moved, games_finished=int(graphed[1].done.sum()),
                 card=card)
    log(f"[20 graph vs eager 1-ply] every integer and bool field of {steps} steps and the "
        f"final state bit-equal, before and after a td.update: {json.dumps(stats)}")
    if moved == 0:
        raise AssertionError("the update did not move the values")
    return stats


def phase_graph_vs_eager_2ply(P, dev, card):
    """The 2-ply rollout graphed (8 steps, chunk 4), both kernels inside the
    graph, against the eager loop."""
    cfg = twoply_config(P)
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    steps, chunk = STEPS_2PLY, 4
    eager, graphed, launches = eager_and_graphed(P, params, cfg, B_TWOPLY, steps, chunk, 13, dev)
    dv = compare_rollouts(eager, graphed, "graphed vs eager 2-ply")
    _gate(launches, {"fused_value": FV_LAUNCHES_PER_STEP_2PLY * steps,
                     "nd_tail": ND_LAUNCHES_PER_STEP * steps}, "graphed 2-ply")
    stats = dict(batch=B_TWOPLY, steps=steps, chunk=chunk, launches=launches, max_abs_dv=dv,
                 card=card)
    log(f"[21 graph vs eager 2-ply] every integer and bool field bit-equal: {json.dumps(stats)}")
    return stats


def _graph_busy(run, steps, dev):
    """(device busy ms, host wall ms) a step of one call of ``run`` (a
    graphed rollout or match) under torch.profiler: both from the same
    run, so 1 - busy / wall is that run's idle share. Busy is None where
    the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(_dev_t(e) for e in _device_events(prof))
    return (busy_us / steps / 1e3 if busy_us > 0 else None), wall_ms / steps


def _last_graph(P):
    """The graph the last graphed call captured or replayed."""
    G = P["graphs"].GRAPHS
    if not G:
        raise AssertionError("no CUDA graph was captured")
    return G[next(reversed(G))]


def phase_graph_times(P, dev, card):
    """Graphed ms a step and env-steps/s: 1-ply (B = 4096) at chunk 1, 4 and
    16, 2-ply (B = 1024) at chunk 1 and 4. Each: the first call's capture +
    instantiate seconds and the graph pool's bytes (memory_stats before and
    after the capture); then a timed call of replays only (host clock around
    it, card synchronised), its launches gated, the device's busy time
    under torch.profiler in a third call, and the graph's replays alone
    queued behind a spin kernel (CUDA events)."""
    R, VE, fv, nd = P["rollout"], P["vec_env"], P["fv"], P["nd"]
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    out = {}
    for name, cfg, batch, steps, chunks, per_step in (
        ("1ply", production_config(P), B_PROD, GRAPH_STEPS_1PLY, (1, 4, 16),
         {"fused_value": 2, "nd_tail": 0}),
        ("2ply", twoply_config(P), B_TWOPLY, STEPS_2PLY, (1, 4),
         {"fused_value": FV_LAUNCHES_PER_STEP_2PLY, "nd_tail": ND_LAUNCHES_PER_STEP}),
    ):
        temp = cfg.train.initial_temperature
        gen = torch.Generator(device=dev).manual_seed(14)
        for chunk in chunks:
            P["graphs"].clear_graphs()
            state = VE.reset(batch, gen, device=dev)
            state, _ = R.rollout_chunked(params, state, temp, cfg, chunk, chunk=chunk,
                                         gen=gen, device=dev)  # captures
            g = _last_graph(P)
            info = dict(g.info)
            _sync(dev)
            fv.KERNEL.launches = nd.KERNEL.launches = 0
            t0 = time.perf_counter()
            state, traj = R.rollout_chunked(params, state, temp, cfg, steps, chunk=chunk,
                                            gen=gen, device=dev)
            _sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {"fused_value": fv.KERNEL.launches, "nd_tail": nd.KERNEL.launches}
            _gate(launches, {k: n * steps for k, n in per_step.items()},
                  f"graphed {name} chunk {chunk}")
            busy, prof_ms = _graph_busy(lambda: R.rollout_chunked(
                params, state, temp, cfg, steps, chunk=chunk, gen=gen, device=dev), steps, dev)
            # the graph alone, replays queued ahead of the card: the
            # step's device time with no host in the way
            graph_ms = _queued_ms_per_round([g.graph.replay], dev,
                                            rounds=max(2, 16 // chunk)) / chunk
            ms = wall_ms / steps
            row = {**info, **dict(
                batch=batch, steps=steps, chunk=chunk, ms_per_step=ms,
                env_steps_per_s=batch * steps / (wall_ms / 1e3),
                device_busy_ms_per_step=busy, profiled_ms_per_step=prof_ms,
                idle_share=None if busy is None else 1 - busy / prof_ms,
                graph_replay_device_ms_per_step=graph_ms,
                launches=launches, games_finished=int(traj.done.sum()),
                values_finite=bool(torch.isfinite(traj.value).all()), card=card)}
            log(f"[22 graph times] {name}: {json.dumps(row)}")
            if not row["values_finite"]:
                raise AssertionError(f"graphed {name} values not finite")
            out[f"{name}_chunk{chunk}"] = row
    P["graphs"].clear_graphs()
    return out


# ---------------------------------------------------------------------------
# the row take (P1-P3), the arena and the evaluate and play CLIs
# ---------------------------------------------------------------------------


def take_bound(boards, idx):
    """Least time for take_rows on these inputs, bound by bytes (it does no
    arithmetic beyond addresses): the distinct in-range source rows each
    game's indices use, read once, the indices, and N x K x C bytes
    written, over HBM bandwidth."""
    n, w, c = boards.shape
    k = idx.shape[1]
    ok = (idx >= 0) & (idx < w)
    used = torch.zeros((n, w), dtype=torch.int32, device=boards.device)
    used.scatter_reduce_(1, idx.long().clamp(0, w - 1), ok.int(), reduce="amax")
    rows = int(used.sum())
    nbytes = rows * c + idx.numel() * idx.element_size() + n * k * c
    return dict(rows_used_per_game=rows / n, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def take_cases(P, dev):
    """Phase 23's inputs: the probe's own (N = 4096, K = W = 128), an N that
    is a multiple of no block, the actor's tier-1 take shape (K = 96 from
    W = 448, int64 indices as ``board_take`` has them), that shape with
    indices outside [0, W), and the sorted engine's four take shapes at
    N = 4096 with int64 indices as it has them (the first-ply take, W = 27,
    also with indices outside [0, W))."""
    gen = torch.Generator(device=dev).manual_seed(23)

    def rand(n, w, k, dtype, outside=0):
        boards = torch.randint(0, 5, (n, w, 52), generator=gen, device=dev, dtype=torch.int8)
        idx = torch.randint(0, w, (n, k), generator=gen, device=dev, dtype=dtype)
        if outside:
            bad = torch.tensor([-1, w, w + 5, -(2**31)], device=dev, dtype=dtype)
            pos = torch.randint(0, idx.numel(), (outside,), generator=gen, device=dev)
            idx.view(-1)[pos] = bad[torch.arange(outside, device=dev) % 4]
        return boards, idx

    return [
        ("probe", *P["probe"].inputs(4096, dev)),
        ("n4099", *rand(4099, 128, 128, torch.int32)),
        ("actor_tier1", *rand(4096, 448, 96, torch.int64)),
        ("outside", *rand(4096, 448, 96, torch.int32, outside=4096)),
        ("sorted_w27_outside", *rand(4096, 27, 512, torch.int64, outside=4096)),
    ] + [(name, *rand(B_SORTED, w, k, torch.int64)) for name, w, k in SORTED_TAKES]


def phase_take(P, dev, card):
    """23: take_rows bit-equal to its plain version (and to torch.gather on
    in-range indices) at every case's shape, timed against both; then the
    probe entry point, in-process (its launches counted from 0) and as
    subprocesses, one mode of each of P1, P2 and P3."""
    T, probe = P["take"], P["probe"]
    rows = {}
    for name, boards, idx in take_cases(P, dev):
        n, w, c = boards.shape
        k = idx.shape[1]
        got = T.take_rows(boards, idx)
        want = T.take_rows_plain(boards, idx)
        ok = (idx >= 0) & (idx < w)
        # torch.gather as board_take calls it (an int64 index expanded
        # along C, stride 0); it faults on an index outside [0, W), so it
        # is given the clamped indices, the same ones where all are in range
        lidx = idx.clamp(0, w - 1)
        lib = probe.torch_gather(boards, lidx)
        _sync(dev)
        err = int((got.int() - want.int()).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(f"[23 take] {name}: kernel differs from its plain version")
        if not torch.equal(got[ok], lib[ok]) or bool(got[~ok].any()):
            raise AssertionError(f"[23 take] {name}: kernel differs from torch.gather")
        kern = functools.partial(T.launch_kernel, boards, idx)
        gather = functools.partial(probe.torch_gather, boards, lidx)
        # kernel, library, library, kernel: each queued behind the spin
        k1, l1, l2, k2 = (_queued_ms_per_round([f], dev, rounds=20)
                          for f in (kern, gather, gather, kern))
        plain_ms = _time_ms(lambda: T.take_rows_plain(boards, idx), dev, 10)
        row = dict(case=name, n=n, w=w, k=k, idx_dtype=str(idx.dtype).split(".")[-1],
                   outside=int((~ok).sum()), max_abs_err=err, ms=(k1 + k2) / 2,
                   library_ms=(l1 + l2) / 2, plain_ms=plain_ms, runs_ms=[k1, l1, l2, k2],
                   plan=T.plan(n, w, k, c), **take_bound(boards, idx))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        log(f"[23 take] {json.dumps(row)} {card}")
        rows[name] = row
    del boards, idx, got, want, lib, lidx

    T.KERNEL.launches = 0
    for mode in PROBE_MODES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = probe.main([mode])
        out = buf.getvalue().splitlines()
        log(f"[23 take] probe_take.main([{mode!r}]) -> {rc}: {out} {card}")
        if rc != 0 or out[:1] != ["exact: True"]:
            raise AssertionError(f"[23 take] the probe's {mode} mode was not exact")
    launches = T.KERNEL.launches
    _gate(launches, len(PROBE_MODES) * (1 + probe.ITERS), "probe_take take_rows")

    cmd = [sys.executable, "-m", "mlp_ppo_2ply_multi_tpu_torch.scripts.probe_take"]
    procs = [subprocess.Popen(cmd + [m], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for m in PROBE_MODES]
    try:
        for mode, proc in zip(PROBE_MODES, procs):
            out, err = proc.communicate(timeout=300)
            log(f"[23 take] python -m ...scripts.probe_take {mode} -> rc {proc.returncode}: "
                f"{out.strip().splitlines()}")
            if proc.returncode != 0 or not out.startswith("exact: True"):
                raise AssertionError(f"[23 take] probe_take {mode} subprocess failed:\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rows, launches


def eval_config(P, movegen=None):
    """The evaluate CLI's config (``make_cfg``: ``Config()`` with the exact
    2-ply scorer) in td_mode "side0", the one the checkpoint was trained in."""
    C = P["cfg"]
    cfg = C.Config(twoply=C.TwoPlyConfig(enabled=True), train=C.TrainConfig(td_mode="side0"))
    return cfg if movegen is None else cfg.replace(movegen=movegen)


def numpy_match(P, cfg, batch, steps, seed):
    """A start state and ``steps`` MatchNoise from one numpy stream (CPU
    tensors): opening rolls, then per step side A's and side B's Gumbel
    noise and the next dice."""
    import numpy as np

    A, VE = P["arena"], P["vec_env"]
    rng = np.random.default_rng(seed)
    pairs = torch.from_numpy(VE._ND_PAIRS)
    start = VE.reset_from_rolls(pairs[torch.from_numpy(rng.integers(0, 30, batch))],
                                pairs[torch.from_numpy(rng.integers(0, 30, batch))])
    w = A.noise_width(cfg)
    noise = []
    for _ in range(steps):
        u = np.maximum(rng.random((2, batch, w), dtype=np.float32), np.finfo(np.float32).tiny)
        g = torch.from_numpy(-np.log(-np.log(u)))
        dice = torch.from_numpy(rng.integers(1, 7, (batch, 2)).astype(np.int32))
        noise.append(A.MatchNoise(g[0], g[1], dice))
    return start, noise


def phase_arena_card_vs_cpu(P, dev, card):
    """24: greedy vs greedy and random vs greedy at B = 32, 64 steps, the
    small widths of the CPU tests, from one numpy stream of dice and noise:
    the graphed match on the card gives the CPU's MatchResult."""
    A, C = P["arena"], P["cfg"]
    small = C.MoveGenConfig(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48,
                            dd_subbatch_div=3)
    cfg = eval_config(P, small)
    start, noise = numpy_match(P, cfg, B_ARENA_SMALL, ARENA_SMALL_STEPS, 24)
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    out = {}
    for name, pa, pb in (("greedy_vs_greedy", A.greedy_policy(cfg), A.greedy_policy(cfg)),
                         ("random_vs_greedy", A.random_policy(cfg), A.greedy_policy(cfg))):
        res = {}
        for where, p in (("card", params), ("cpu", cpu_params)):
            d = dev if where == "card" else torch.device("cpu")
            res[where] = A.play_match(p, p, pa, pb, None, cfg, B_ARENA_SMALL, ARENA_SMALL_STEPS,
                                      device=d, noise=noise,
                                      start=P["tree"].tmap(lambda t: t.to(d), start))
        _sync(dev)
        for f in ("winner", "win_type", "steps"):
            if not torch.equal(getattr(res["card"], f).cpu(), getattr(res["cpu"], f)):
                raise AssertionError(f"[24 arena card vs cpu] {name}: {f} differs")
        out[name] = A.summarize(res["card"])
        log(f"[24 arena card vs cpu] {name}, B={B_ARENA_SMALL}, {ARENA_SMALL_STEPS} steps: "
            f"MatchResult equal on the card and the CPU: {json.dumps(out[name])} {card}")
    P["graphs"].clear_graphs()
    return out


def eval_nd_inputs(P, params, cfg, dev):
    """The nd_tail inputs of one eager match step at the evaluate CLI's
    defaults: the merged legal moves' single-pass tail, K = 576."""
    A, nd, VE = P["arena"], P["nd"], P["vec_env"]
    seen = []
    real = nd.nd_tail_fused

    def keep(*args):
        seen.append(args)
        return real(*args)

    gen = torch.Generator(device=dev).manual_seed(250)
    m = A._Match(VE.reset(B_EVAL, gen, device=dev),
                 torch.full((B_EVAL,), -1, dtype=torch.int32, device=dev))
    pol = A.greedy_policy(cfg)
    with _Swap(nd, "nd_tail_fused", keep):
        A.match_step(params, params, pol, pol, cfg, m, A.draw_match_noise(B_EVAL, cfg, gen, dev))
    _sync(dev)
    return seen


def phase_eval_graph_vs_eager(P, dev, card):
    """25: matches at the evaluate CLI's defaults (``Config()``, B = 1024,
    400 steps, chunk 16) with the checkpoint's weights, greedy vs random and
    greedy vs greedy: the graphed match bit-equal to the eager step loop from
    the same generator seed (winners, win types, steps, final boards),
    checkers conserved, one nd_tail launch a match step (the merged legal
    moves' single-pass tail at K = 576) counted by replay; then ms a match
    step, games/s, idle share and capture seconds; and nd_tail at K = 576
    against its plain version, timed."""
    A, VE, nd, Bd = P["arena"], P["vec_env"], P["nd"], P["board"]
    cfg = eval_config(P)
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    out = {"launches": 0}
    for i, (name, pa, pb) in enumerate((
            ("greedy_vs_random", A.greedy_policy(cfg), A.random_policy(cfg)),
            ("greedy_vs_greedy", A.greedy_policy(cfg), A.greedy_policy(cfg)))):
        P["graphs"].clear_graphs()
        seed = 25 + 10 * i
        gen = torch.Generator(device=dev).manual_seed(seed)
        m = A._Match(VE.reset(B_EVAL, gen, device=dev),
                     torch.full((B_EVAL,), -1, dtype=torch.int32, device=dev))
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(EVAL_STEPS):
            m = A.match_step(params, params, pa, pb, cfg, m,
                             A.draw_match_noise(B_EVAL, cfg, gen, dev))
        _sync(dev)
        eager_ms = (time.perf_counter() - t0) * 1e3 / EVAL_STEPS

        run = lambda s: A.play_match(params, params, pa, pb,
                                     torch.Generator(device=dev).manual_seed(s), cfg,
                                     B_EVAL, EVAL_STEPS, device=dev, chunk=EVAL_CHUNK)
        nd.KERNEL.launches = 0
        res = run(seed)  # the first chunk eager, the capture, then replays
        _sync(dev)
        launches = nd.KERNEL.launches
        _gate(launches, EVAL_STEPS, f"graphed match {name} nd_tail")
        g = _last_graph(P)
        final = g.match.state.board
        for f, a, b in (("winner", res.winner, m.winner), ("win_type", res.win_type, m.state.win_type),
                        ("steps", res.steps, m.state.step_count),
                        ("final boards", final.data, m.state.board.data)):
            if not torch.equal(a, b):
                raise AssertionError(f"[25 eval graph vs eager] {name}: {f} differ")
        if not bool(Bd.checker_conservation_ok(final).all()):
            raise AssertionError(f"[25 eval graph vs eager] {name}: checkers not conserved")

        nd.KERNEL.launches = 0
        t0 = time.perf_counter()
        res2 = run(seed + 1)  # replays only
        _sync(dev)
        wall = time.perf_counter() - t0
        _gate(nd.KERNEL.launches, EVAL_STEPS, f"replayed match {name} nd_tail")
        launches += nd.KERNEL.launches
        busy, prof_ms = _graph_busy(lambda: run(seed + 2), EVAL_STEPS, dev)
        graph_ms = _queued_ms_per_round([g.graph.replay], dev, rounds=2) / EVAL_CHUNK
        ms = wall * 1e3 / EVAL_STEPS
        row = {**g.info, **dict(
            batch=B_EVAL, steps=EVAL_STEPS, chunk=EVAL_CHUNK, ms_per_step=ms,
            games_per_s=B_EVAL / wall, eager_ms_per_step=eager_ms,
            device_busy_ms_per_step=busy, profiled_ms_per_step=prof_ms,
            idle_share=None if busy is None else 1 - busy / prof_ms,
            graph_replay_device_ms_per_step=graph_ms, nd_tail_launches=launches,
            summary=A.summarize(res), summary_replayed=A.summarize(res2), card=card)}
        log(f"[25 eval graph vs eager] {name}: graphed and eager bit-equal, checkers "
            f"conserved: {json.dumps(row)}")
        out[name] = row
        out["launches"] += launches
    P["graphs"].clear_graphs()

    seen = eval_nd_inputs(P, params, cfg, dev)
    if [(a[0].shape[0], a[7], a[8]) for a in seen] != [(B_EVAL, 576, 512)]:
        raise AssertionError(f"[25] unexpected eval nd_tail calls {[(a[0].shape, a[7:]) for a in seen]}")
    args = seen[0]
    K, a_max = args[7], args[8]
    got, want = nd.nd_tail_fused(*args), nd.nd_tail_plain(*args)
    _sync(dev)
    keep = want[1]
    if not (torch.equal(got[1], want[1]) and all(torch.equal(x, y) for x, y in zip(got[2:], want[2:]))
            and torch.equal(got[0][keep], want[0][keep])):
        raise AssertionError("[25] nd_tail at K = 576 differs from its plain version")
    ops = nd.kernel_operands(*args[:7], K)
    kern = functools.partial(nd.launch_kernel, *ops, K, a_max)
    k1 = _queued_ms_per_round([kern], dev)
    plain_ms = _time_ms(lambda: nd.nd_tail_plain(*args), dev, 5)
    k2 = _queued_ms_per_round([kern], dev)
    bound = nd_tail_bound(args[0], K)
    out["nd_tail_k576"] = dict(ms_per_launch=(k1 + k2) / 2, runs_ms=[k1, k2], plain_ms=plain_ms,
                               **bound, bound_share=bound["bound_ms"] / ((k1 + k2) / 2))
    log(f"[25 eval graph vs eager] nd_tail at K = 576 on the eval path, bit-equal to its plain "
        f"version: {json.dumps(out['nd_tail_k576'])} {card}")
    return out


EVAL_RUNS = (
    ("random", ["--opponent", "random"]),
    ("greedy", ["--opponent", "greedy"]),
    ("twoply", ["--opponent", "twoply", "--checkpoint", str(CKPT), "--td-mode", "side0"]),
    ("twoply_agent", ["--agent-policy", "twoply", "--games", str(B_EVAL_TWOPLY_AGENT),
                      "--checkpoint", str(CKPT), "--td-mode", "side0"]),
)
SUMMARY_KEYS = {"games", "finished", "win_rate_a", "win_rate_b", "unfinished", "gammons",
                "backgammons"}


def phase_evaluate_cli(P, dev, card):
    """26: ``apps.evaluate.main`` on the card at its defaults (Config(),
    1024 games, 400 steps): vs random and vs greedy with no flag at all (an
    untrained net), vs 2-ply (the checkpoint, td_mode side0), and a 2-ply
    agent at 256 games; each prints JAX's summary keys with finished > 0, and runs
    nd_tail once a match step plus 15 times a step for each 2-ply side (its
    15 non-double reply rolls)."""
    A, nd = P["arena"], P["nd"]
    out = {"launches": 0}
    for name, argv in EVAL_RUNS:
        P["graphs"].clear_graphs()
        buf = io.StringIO()
        _sync(dev)
        nd.KERNEL.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = P["evaluate"].main(argv)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = nd.KERNEL.launches
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        games = B_EVAL_TWOPLY_AGENT if "--games" in argv else B_EVAL
        _gate(launches, EVAL_STEPS * (1 + 15 * name.startswith("twoply")),
              f"evaluate {name} nd_tail")
        row = dict(argv=argv, rc=rc, wall_s=wall, ms_per_step=wall * 1e3 / EVAL_STEPS,
                   nd_tail_launches=launches, summary=summary, card=card)
        log(f"[26 evaluate cli] {json.dumps(row)}")
        if rc != 0 or set(summary) != SUMMARY_KEYS or summary["games"] != games \
                or summary["finished"] <= 0:
            raise AssertionError(f"[26 evaluate cli] {name}: {rc} {summary}")
        out[name] = row
        out["launches"] += launches
    P["graphs"].clear_graphs()
    return out


def phase_play_cli(card):
    """27: ``apps.play`` with --engine torch on the card (and --engine
    oracle) in a subprocess, the human's moves piped in (always move 0):
    both exit 0 at the game's end, and the agent plays the same moves."""
    moves = {}
    for engine in ("torch", "oracle"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mlp_ppo_2ply_multi_tpu_torch.apps.play", "--engine", engine,
             "--seed", "7", "--show-values"],
            input="0\n" * 400, capture_output=True, text=True, timeout=600, cwd=ROOT)
        lines = proc.stdout.splitlines()
        moves[engine] = [x for x in lines if x.startswith("agent plays")]
        log(f"[27 play cli] --engine {engine}: rc {proc.returncode}, "
            f"{time.perf_counter() - t0:.1f} s, {len(moves[engine])} agent moves, "
            f"{lines[-1] if lines else ''!r} {card}")
        if proc.returncode != 0 or not any(x.startswith("game over") for x in lines):
            raise AssertionError(f"[27 play cli] --engine {engine} failed:\n{proc.stderr[-2000:]}")
    if len(moves["torch"]) < 5 or moves["torch"] != moves["oracle"]:
        raise AssertionError("[27 play cli] the torch engine's agent moves differ from the oracle's")
    return len(moves["torch"])



# ---------------------------------------------------------------------------
# the sorted reference-order engine and the trajectory games
# ---------------------------------------------------------------------------


def sorted_states(P, batch, dev, gen, steps=4):
    """States ``steps`` canonical decisions off the opening: merged
    canonical legal moves, a uniform legal action from ``gen``."""
    VE, mg = P["vec_env"], P["cfg"].MoveGenConfig()
    state = VE.reset(batch, gen, device=dev)
    for _ in range(steps):
        moves = P["movegen"].legal_moves(state.board, state.player, state.dice, mg)
        raw = torch.randint(0, 2**31 - 1, (batch,), generator=gen, device=dev)
        action = raw % moves.count.clamp(min=1)
        state = VE.step(state, moves, action, VE.roll_dice(gen, (batch,), dev),
                        P["cfg"].EnvConfig()).state
    return state


def phase_sorted_engine(P, dev, card):
    """28: the sorted engine (``movegen.legal_moves`` with algo "sorted"):
    card vs CPU at B = 256, one decision at B = 4096 with every
    synchronising op made to raise, its ms, peak memory and top device ops,
    then the port's
    trajectory script over the 4096 games of ``artifacts/traj_jax_4096.jsonl``
    on the card: every hash equal, the transcript sha256 of
    ``artifacts/trajectory_parity.json``, exactly 8 take_rows launches a
    decision."""
    M, T, TP = P["movegen"], P["take"], P["traj"]
    mg = P["cfg"].MoveGenConfig(algo="sorted")
    gen = torch.Generator(device=dev).manual_seed(28)
    state = sorted_states(P, B_SORTED_SMALL, dev, gen)
    got = M.legal_moves(state.board, state.player, state.dice, mg)
    cpu = _to_cpu(state)
    want = M.legal_moves(cpu.board, cpu.player, cpu.dice, mg)
    for name, a, b in (("boards", got.boards.data, want.boards.data),
                       ("valid", got.valid, want.valid), ("count", got.count, want.count)):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError(f"[28 sorted] card vs CPU: {name} differs")
    doubles = int((cpu.dice[:, 0] == cpu.dice[:, 1]).sum())
    log(f"[28 sorted] card vs CPU at B={B_SORTED_SMALL}: boards, valid and count bit-equal "
        f"({int(want.count.sum())} moves, {doubles} doubles rolls) {card}")

    state = sorted_states(P, B_SORTED, dev, gen)
    M.legal_moves(state.board, state.player, state.dice, mg)
    _sync(dev)
    with syncs_raise(dev):
        ms = M.legal_moves(state.board, state.player, state.dice, mg)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    M.legal_moves(state.board, state.player, state.dice, mg)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    dec_ms = _time_ms(lambda: M.legal_moves(state.board, state.player, state.dice, mg), dev, 5)
    log(f"[28 sorted] one decision at B={B_SORTED}: no op synchronised the host with the card; "
        f"{dec_ms:.3f} ms a decision (CUDA events, 5 after 3), peak {peak / 2**30:.3f} GiB "
        f"above its inputs; {int(ms.count.sum())} moves {card}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        M.legal_moves(state.board, state.player, state.dice, mg)
        _sync(dev)
    ev = _device_events(prof)
    busy = sum(_dev_t(e) for e in ev) / 1e3
    log(f"[28 sorted] profiler, one decision: device busy {busy:.3f} ms of "
        f"{dec_ms:.3f}, {sum(e.count for e in ev)} device ops {card}")
    for e in sorted(ev, key=_dev_t, reverse=True)[:10]:
        log(f"[28 sorted]   {_dev_t(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    del state, ms, got

    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return M.legal_moves(*a, **k)

    T.KERNEL.launches = 0
    t0 = time.perf_counter()
    with _Swap(TP, "legal_moves", counted):
        recs = TP.run(B_SORTED, device=dev, log=lambda m: log(f"[28 sorted] {m}"))
    wall = time.perf_counter() - t0
    launches = T.KERNEL.launches
    result = TP.compare(TP.load(str(TRAJ_HASHES)), {r["g"]: r for r in recs})
    sha = json.loads(TRAJ_PARITY.read_text())["transcript_sha256"]
    log(f"[28 sorted] trajectory games: {json.dumps(result)}; {wall:.1f} s wall, "
        f"{calls[0]} decisions of the shrinking batch, {launches} take_rows launches {card}")
    if result["games_compared"] != B_SORTED or result["bit_identical"] != B_SORTED:
        raise AssertionError(f"[28 sorted] {result['bit_identical']}/{result['games_compared']} "
                             "trajectory hashes equal the artifact's")
    if result["transcript_sha256"] != sha:
        raise AssertionError("[28 sorted] transcript sha256 differs from trajectory_parity.json")
    _gate(launches, SORTED_TAKES_PER_DECISION * calls[0], "trajectory take_rows")
    return dict(launches=launches, decisions=calls[0], wall_s=wall, ms_per_decision=dec_ms,
                peak_gib=peak / 2**30, **result)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 2
    P = _port()
    # the plain version's matmuls must run in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    name, count, smi = phase_device()
    card = f"[{smi}]"
    phase_build(P)

    cfg = production_config(P)
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = P["vec_env"].reset(B_PROD, gen, device=dev)
    state, real_inputs = capture_candidates(P, params, state, cfg, dev, gen)
    if [tuple(b.shape[:-1]) for b, _ in real_inputs] != [(B_PROD, 96), (B_PROD // 16, 448)]:
        raise AssertionError(f"unexpected main-path shapes {[b.shape for b, _ in real_inputs]}")
    max_err = phase_kernel_vs_plain(P, params, real_inputs, dev, gen, card)

    state, stats = phase_main_path(P, params, state, cfg, dev, gen, card)
    phase_same_step(P, params, state, cfg, dev, gen, card)
    phase_card_vs_cpu(P, params, cfg, dev, gen, card)
    phase_time_breakdown(P, params, state, cfg, dev, gen, stats["ms_per_step"], card)
    fv1_step = phase_kernel_timing(P, params, real_inputs, dev, card)
    del real_inputs, state

    cfg2 = twoply_config(P)
    state2 = P["vec_env"].reset(B_TWOPLY, gen, device=dev)
    state2 = twoply_steps(P, params, state2, cfg2, dev, gen, 2)  # off the opening
    state2, nd_seen, fv_seen = capture_twoply_inputs(P, params, state2, cfg2, dev, gen)
    reply = B_TWOPLY * cfg2.twoply.top_k_candidates
    shapes = [tuple(b.shape[:-1]) for b, _ in fv_seen]
    want = [(B_TWOPLY, 448)] + [(B_TWOPLY, 4, 96)] * 15 + [(B_TWOPLY, 4, 64)] * 3 + [
        (B_TWOPLY, 4, 128)] * 3
    nd_shapes = {(a[0].shape[0], a[7], a[8]) for a in nd_seen}
    if shapes != want or len(nd_seen) != 15 or nd_shapes != {(reply, 96, 96)}:
        raise AssertionError(f"unexpected 2-ply shapes {shapes} {nd_shapes} x{len(nd_seen)}")
    nd_err, fv2_err = phase_twoply_kernels_vs_plain(P, params, nd_seen, fv_seen, dev, gen, card)
    state2, stats2 = phase_twoply_main(P, params, state2, cfg2, dev, gen, card)
    phase_twoply_kernel_vs_no_kernel(P, params, state2, cfg2, dev, gen, card)
    phase_twoply_card_vs_cpu(P, params, cfg2, dev, gen, card)
    R, X, VE = P["rollout"], P["X"], P["vec_env"]
    stages2 = [
        ("noise", R, "draw_noise"), ("movegen", R, "legal_moves"),
        ("select_action_2ply", R, "select_action_2ply"), ("env", VE, "step"),
        ("reset", VE, "reset_where"),
    ]
    inner2 = [("scorer", X, "weighted_opponent_response"), ("nd_tail", P["nd"], "nd_tail_fused"),
              ("fused_value", X, "fused_value")]
    state2 = stage_times(P, params, state2, cfg2, dev, gen, 3, stages2, inner2,
                         "[13 time 2-ply]", card)
    profile_steps(P, params, state2, cfg2, dev, gen, 2, stats2["ms_per_step"], card,
                  "[13 time 2-ply]")
    nd_step, fv2_step = phase_twoply_kernel_timing(P, params, nd_seen, fv_seen, dev, card)
    del nd_seen, fv_seen, state2

    phase_learner(P, dev, gen, card)
    train1 = phase_train_1ply(P, dev, gen, card)
    train2 = phase_train_2ply(P, dev, card)
    train_sync = phase_train_sync(P, dev, card)
    trains = {"train_1ply": train1, "train_2ply": train2, "train_sync": train_sync}

    P["graphs"].clear_graphs()
    phase_no_sync(P, params, [("1-ply", cfg, B_PROD), ("2-ply", cfg2, B_TWOPLY)], dev, gen, card)
    g1 = phase_graph_vs_eager_1ply(P, dev, card)
    g2 = phase_graph_vs_eager_2ply(P, dev, card)
    gt = phase_graph_times(P, dev, card)
    graph_fv = (g1["launches"] + g1["launches_after_update"] + g2["launches"]["fused_value"]
                + sum(r["launches"]["fused_value"] for r in gt.values()))
    graph_nd = g2["launches"]["nd_tail"] + sum(r["launches"]["nd_tail"] for r in gt.values())

    take_rows, take_launches = phase_take(P, dev, card)
    phase_arena_card_vs_cpu(P, dev, card)
    ev = phase_eval_graph_vs_eager(P, dev, card)
    cli = phase_evaluate_cli(P, dev, card)
    phase_play_cli(card)
    srt = phase_sorted_engine(P, dev, card)
    eval_nd = ev["launches"] + cli["launches"]
    nd576 = ev["nd_tail_k576"]
    probe = take_rows["probe"]

    kernels = [
        {
            "name": "fused_value",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            # every path's timed run, each counted from 0 just before it
            "launches": stats["fused_value_launches"] + stats2["fused_value_launches"]
            + sum(t["launches"]["fused_value"] for t in trains.values()) + graph_fv,
            "max_abs_err": max(max_err, fv2_err),
            # one 1-ply production step's two launches (tier 1 + tier 2), summed;
            # ms is their device time with the launches queued ahead of the card
            "ms": fv1_step["ms"],
            "plain_ms": fv1_step["plain_ms"],
            "bound_ms": fv1_step["bound_ms"],
            "bound_by": fv1_step["bound_by"],
            "library_ms": None,
            "paths": {
                "1ply": {"launches": stats["fused_value_launches"], **fv1_step},
                "2ply": {"launches": stats2["fused_value_launches"], **fv2_step},
                **{k: {"launches": t["launches"]["fused_value"]} for k, t in trains.items()},
                "graphs": {"launches": graph_fv},
            },
            "ok": True,
        },
        {
            "name": "nd_tail",
            "route": "cuda",
            "source": ND_SOURCE,
            "replaces": ND_REPLACES,
            "launches": stats2["nd_tail_launches"] + train2["launches"]["nd_tail"] + graph_nd
            + eval_nd,
            "max_abs_err": nd_err,
            # one 2-ply step's 15 launches at [4096 rows, K = 96], summed
            "ms": nd_step["ms"],
            "plain_ms": nd_step["plain_ms"],
            "bound_ms": nd_step["bound_ms"],
            "bound_by": nd_step["bound_by"],
            "library_ms": None,
            "ms_per_launch": nd_step["ms"] / nd_step["calls_per_step"],
            "wrapper_ms": nd_step["wrapper_ms"],
            "paths": {"2ply": {"launches": stats2["nd_tail_launches"]},
                      "train_2ply": {"launches": train2["launches"]["nd_tail"]},
                      "graphs": {"launches": graph_nd},
                      # the graphed matches of phase 25 and the evaluate CLI
                      # runs of phase 26; one launch at [1024, K = 576] timed
                      "eval": {"launches": eval_nd, "K": 576,
                               "ms_per_launch": nd576["ms_per_launch"],
                               "plain_ms": nd576["plain_ms"], "bound_ms": nd576["bound_ms"],
                               "bound_by": nd576["bound_by"]}},
            "ok": True,
        },
        {
            "name": "take_rows",
            "route": "cuda",
            "source": TAKE_SOURCE,
            "replaces": TAKE_REPLACES,
            # the probe entry point's run (phase 23) and the trajectory
            # games' (phase 28), each counted from 0
            "launches": take_launches + srt["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in take_rows.values()),
            # one launch at the probe's shape, [4096, K = 128] from W = 128
            "ms": probe["ms"],
            "plain_ms": probe["plain_ms"],
            "bound_ms": probe["bound_ms"],
            "bound_by": probe["bound_by"],
            "library_ms": probe["library_ms"],  # torch.gather, which the port never calls here
            "paths": {"probe": {"launches": take_launches, "modes": list(PROBE_MODES)},
                      "sorted": {"launches": srt["launches"], "decisions": srt["decisions"],
                                 "per_decision": SORTED_TAKES_PER_DECISION,
                                 # timed in phase 23, under "shapes"
                                 "shapes": [n for n, _, _ in SORTED_TAKES]}},
            "shapes": take_rows,
            "ok": True,
        },
    ]
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
