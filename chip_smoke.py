#!/usr/bin/env python3
"""Drive the PyTorch port's two self-play paths, its training loop (on one
card and as the mesh train step), its evaluation and play CLIs, the
row-take probe and the rules-parity and quality tools on one CUDA card and
check them.

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
run the redesigned take_rows; path 10 the mesh train step
(``parallel.sharding.make_train_step``) through the training CLI with
--fused-rollout on a one-rank NCCL group, and on two gloo ranks sharing the
card (``scripts.multiprocess_distributed``). Paths 11-15 are the JAX
package's rejected experiments, default-off there and here: the tiered 1-ply
step (``experimental.tiered``, ``train --tiered``) at B = 4096, whose wide
plane runs nd_tail at K = 288 and both its planes fused_value; the Gram
dedup (``nd_sig_dedup=False``) on the production step; the 2-ply scan
scorer and value-first replies at B = 1024; and the probe's one-hot
product modes. Paths 16-19 are the repo's rules-parity and quality tools
(``scripts.stress_movegen2``, ``scripts.twoply_decision_guard``,
``scripts.run_parity_trainer`` with ``scripts.eval_curve``, and the
evaluate CLI's tuned-vs-exact 2-ply head-to-head), whose merged legal
moves and reply enumerations run nd_tail at ``Config()``'s widths. Paths
20-23 are the repo's measurement tools (``scripts.bench``,
``scripts.bench_twoply``, ``scripts.roofline``, ``scripts.trace_attr``,
``scripts.bench_r2_sweep`` and ``scripts.bench_spmd``), which drive paths 1
and 2 and their variants.
Phases, in order; any failure exits non-zero:

1. device: torch's view of the card and nvidia-smi's name and power limit;
2. build: one nvcc per kernel source, started together (seconds,
   registers, spills, shared memory), and the tensor-core instructions
   (HMMA/HGMMA) in fused_value_kernel's SASS, which must not be 0; then
   the tracer's stamp kernel against its plain version on one script of
   stamps (columns 0-3, each row kind, the cursor wrapping past the ring's
   slots): cursors, sequence columns and untouched cells equal, the card's
   stamps rising in launch order and reading a spin's CUDA-event time in
   nanoseconds;
3. kernel vs plain (1-ply): fused_value against ``fused_value_plain`` at
   the main path's two shapes, on random in-domain boards and on the real
   candidate boards of a production step; (3b) nd_tail on that step's two
   tier calls ([4096, K = 96] and [512, K = 288]) bit-equal to its plain
   version, ``after`` at every slot;
4. main path (1-ply): warm-up, then timed production steps with the launch
   counts read around them (two fused_value, two nd_tail and one dd_expand
   launch per step);
5. same step, kernel vs plain: one step from the same state and noise;
   decisions agree on >= 99.9% of rows and the integer state is identical
   on agreeing rows;
6. card vs CPU: one step at B = 256 on the card and through the port's CPU
   path (which the CPU tests hold against the JAX package) — bit-equal
   legal moves, identical integer state on agreeing rows;
7. where the time goes: per-stage host times and a torch.profiler window;
8. kernel timing and bound (1-ply shapes, nd_tail's two tiers included);
9. kernels vs plain (2-ply): the inputs of one 2-ply step's 17 nd_tail (its
   own moves' two tiers and 15 reply rolls) and 22 fused_value calls, each
   kernel against its plain version (nd_tail bit-equal: keep, n_pre, pct,
   kpair everywhere, after at kept slots);
10. main path (2-ply): warm-up, then timed steps; exactly 17 nd_tail, 22
    fused_value and 7 dd_expand launches a step, checkers conserved, values
    finite;
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
    2 x 256 fused_value, 2 x 256 nd_tail and 256 dd_expand launches, the last
    checkpoint restored bitwise on
    the card (params, Adam, version 4, generator state), and fused_value
    against its plain version on the trained params (the packed-params
    cache followed the in-place updates); ms an update, env-steps/s while
    training, the learner's share, peak memory;
17. train, 2-ply: --two-ply --production, B = 1024, 8 steps an update, 2
    updates: exactly 17 nd_tail, 22 fused_value and 7 dd_expand launches a
    step, finite loss;
18. train, sync: --mode sync --production --per-episode-updates, B = 256,
    1 update (one 300-step rollout, then 256 sequential Adam steps): one
    metrics line of finite values at episode count 256, 2 fused_value, 2
    nd_tail and 1 dd_expand launches a step;
19. no sync: one eager 1-ply (B = 4096) and one 2-ply (B = 1024) step with
    the noise drawn ahead under ``torch.cuda.set_sync_debug_mode("error")``:
    no op of the step synchronises the host with the card;
20. graphed vs eager, 1-ply: ``rollout_chunked`` (64 steps, chunk 4: a
    CUDA graph of 4 steps, captured once, replayed) against ``rollout_loop``
    from the same state and generator seed: every integer and bool field of
    the trajectory and the final state bit-equal, max |dv| printed; again
    after one ``td.update`` of the same params tensors; 2 fused_value, 2
    nd_tail and 1 dd_expand launches a step, counted by replay;
21. graphed vs eager, 2-ply: 8 steps at chunk 4, both kernels inside the
    graph, bit-equal; 22 fused_value, 17 nd_tail and 7 dd_expand launches
    a step;
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
29. the mesh train step: (a) ``apps.train.main`` with --production
    --fused-rollout --data 1 --model 1 (B = 4096, 3 updates of 64 steps) on
    a one-rank NCCL group: 3 finite metrics lines with JAX's mesh keys,
    exactly 2 x 64 fused_value, 2 x 64 nd_tail and 64 dd_expand launches an
    update, the
    first update equal
    to the single-card loop's from the same state, games and generator
    (integer trajectory bit-equal, params at phase 15's tolerances), its ms
    an update beside phase 16's, the update's ms and its all-reduces' (each
    timed with the device synchronised around it); (b) two gloo ranks on card 0
    (``scripts/multiprocess_distributed.py --device cuda``): a (2, 1) mesh
    at B = 4096 against one rank on the same games and noise, and a (1, 2)
    tp update at B = 1024 against the update without tp and JAX's tp rule;
    (c) ``--remote-dir`` exits 2 naming fsspec where fsspec does not
    import; (d) the ring buffer's pushes and samples on the card with no
    host sync, a push replayed in a CUDA graph, and the tracer's record of
    a graphed rollout (launch wait + stage ms of the stamped steps x steps)
    within 10% of CUDA events around it;
30. the tiered 1-ply step (``apps.train``'s --production --tiered config):
    card vs CPU at B = 256 (every ``Tiered`` field bit-equal, boards at
    valid slots; integer state on agreeing decisions); fused_value at
    [4096, 96] and [512, 448] and nd_tail at [512, K = 288] on one step's
    real inputs against their plain versions (nd_tail bit-equal), timed
    with their bounds; 8 timed eager steps at B = 4096 with exactly 2
    fused_value and 1 nd_tail launches a step, and 2 under torch.profiler
    (device busy ms a step, idle share); ``rollout_chunked`` (16
    steps, chunk 4) bit-equal to ``rollout_loop``; ``apps.train.main``
    --production --tiered, B = 4096, 2 updates of 64 steps: finite loss,
    launches gated, ms an update;
31. the Gram dedup: the production step at B = 4096 with
    ``nd_sig_dedup=False`` and with signatures from one state and noise:
    identical decisions, planes and integer state; ms a step of each (2
    nd_tail launches a step with signatures, none with the Gram dedup);
32. the 2-ply scan scorer at ``TwoPlyConfig(enabled=True)``'s widths,
    B = 1024: on one state's candidates, chunk 1 bit-equal to the unrolled
    scorer and chunk 3 within rtol 1e-5, atol 1e-6 (15 + 21 and 5 + 7 nd_tail +
    fused_value launches); each scan scorer's kernels on its own captured
    inputs against their plain versions (nd_tail bit-equal at [4096 and
    12288 rows, K = 128], fused_value at [1 and 3, 1024, 4, 128] within
    5e-3), one launch of each timed with its bound; ms a 2-ply step of
    each, launches gated (the step's own moves add 2 nd_tail launches);
33. value-first replies (``value_first_m=16``; 21 fused_value launches, no
    nd_tail): where the inexact flag is clear, equal to the
    reference-order scan (rtol 1e-6, atol 1e-7); ms a step;
34. the probe's modes with no Pallas kernel (``scripts.probe_take`` xla,
    bf16acc, int8, int8acc, f32, packed, ohonly, dotonly, bf16T) in-process
    at N = 4096: each exact (ohonly n/a), with its ms;
35. the rules stress, 4,096 positions of each config against the rules
    oracle: (a) the merged legal moves (nd_tail at [128, K = 576], one
    launch a batch, bit-equal to its plain version and timed), (b) the
    production ``legal_moves_split`` (2 nd_tail launches a batch, the
    tiers); 0 mismatches, overflow rows and
    positions/s;
36. the tuned-vs-exact 2-ply decision guard on 1,024 self-play positions:
    16 nd_tail launches a score call, each call bit-equal to its plain
    version, the card's slots and scores equal to the CPU path's on 32
    (rtol 1e-5, atol 1e-6), agreement >= 0.99, the report's fields;
37. two updates of the parity trainer (checkpoints at episodes 0, 200 and
    400, read back bitwise; JAX's train.jsonl keys; one nd_tail launch a
    rollout step), then the learning curve over them at 256 games: exactly
    2 graphs captured, each checkpoint's winners equal to a separate
    ``play_match`` call;
38. ``apps.evaluate`` tuned 2-ply against exact 2-ply at 256 games: 31
    nd_tail launches a match step, the win rate and wall seconds;
39. the benches: the 1-ply headline (``scripts.bench --eager``: graphed at
    chunk 4 and eager, B = 4096) and the 2-ply bench (tuned and plain,
    B = 1024, a graph of one step): one JSON line each, its keys finite and
    positive, fused_value launched 2 a 1-ply step and 22 a tuned 2-ply step
    (nd_tail 2 and 17); the graphed ms/step beside phase 22's;
40. the roofline (``scripts.roofline all``): the launch floor and the
    measured bf16 and HBM peaks, each at most 1.05 of the published peak;
    both steps' achieved fractions at most 1.05; one 1-ply step's count
    (``utils.cost``) on the card equal to the CPU's;
41. ``scripts.trace_attr`` of the 1-ply step at B = 4096 and the tuned 2-ply
    step at B = 1024: every JAX stage the step passes through owns device
    time; the top stages, the unscoped share and the coverage;
42. ``scripts.bench_r2_sweep`` over prod, prod_gram, tiered and
    twoply_tuned (exit 0, a line each), tier0 refused (exit 1, named), and
    ``scripts.bench_spmd`` at n = 1 on a one-rank NCCL group;
43. the doubles kernel (``ops.dd_expand``) on the inputs of one 1-ply step
    (B = 4096: one call on the 1,024-game doubles sub-batch) and one 2-ply
    step (B = 1024: its own 256 games, six reply dice on 4,096 positions):
    each call byte-equal to the plain chain, timed with CUDA events beside
    its bound and the plain chain, a step's launches queued behind a spin;
44. the deep net's kernel D2 (``ops.mlp_value``, ``ModelConfig.wildbg`` with
    seeded weights) on the calls of one 1-ply step (B = 4096: 2 launches)
    and one 2-ply step (B = 1024: 22 launches), each gated: every call
    against ``mlp_value_plain`` (|dv| within ``mlp_value.SPREAD_TOL`` of the
    spread of the step's values), its rows needed counted
    (the call's valid rows), timed with CUDA events beside its bound and
    the plain version and the kernel valuing every padded slot, a step's
    launches queued behind a spin;

then the kernels line (launches summed over every path's timed run; the
doubles kernel's over the main paths' runs of phases 4, 10, 16-18 and
20-22 and 29a, each gated) and the
result line. Phases 4, 7, 10 and 13 time the eager step; the training runs
(16-18) go through the graphed rollouts, as ``apps.train`` does.

It imports torch, numpy and the port only. It looks for the port first:
copied alone into a directory without ``mlp_ppo_2ply_multi_tpu_torch``
beside it, it prints one line naming the package and the directory and
exits 1; then, without CUDA, it exits 2. Neither prints a result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PORT_PACKAGE = "mlp_ppo_2ply_multi_tpu_torch"

B_PROD = 4096
B_SMALL = 256
WARMUP = 4
STEPS = 32
CKPT = ROOT / "checkpoints" / "side0_20480000.pth"
# kernel vs plain: max |dv| (same rounding points; an f32 summation order
# can move one hidden unit by one bf16 ulp, <= 2^-9, times |w2|)
KERNEL_TOL = 5e-3
AGREE_MIN = 0.999
KERNEL_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/fused_value.cu"
KERNEL_REPLACES = "mlp_ppo_2ply_multi_tpu/ops/fused_value.py:93"
ND_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/experimental/csrc/nd_tail.cu"
ND_REPLACES = "mlp_ppo_2ply_multi_tpu/experimental/nd_tail.py:137"
TAKE_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/take_rows.cu"
TAKE_REPLACES = ("scripts/probe_pallas_batched_dot.py:55 (P1 take_pallas), "
                 "scripts/probe_pallas_batched_dot.py:86 (P2 take_pallas_fused), "
                 "scripts/probe_pallas_batched_dot.py:214 (P3 take_bdiag)")
STAMP_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/stamp.cu"
MLP_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/mlp_value.cu"
MLP_STEPS = (("1ply", B_PROD, 2), ("2ply", 1024, 22))  # (path, batch, launches a step)
MLP_ITERS = 20
DD_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/dd_expand.cu"
# the doubles kernel's widths (w1, w2, w3, w4, a_max): fast(), Config(), the
# tuned 2-ply replies of dies 1-3 and 4-6
DD_WIDTHS = ((16, 96, 224, 448, 448), (16, 128, 288, 512, 512), (16, 64, 96, 64, 64),
             (16, 64, 128, 128, 128))
# phase 2's stamp script, (column, close) in launch order: columns 0-3,
# close 0 and each row kind 1-3, 8 closed rows in 3 slots (two wraps)
STAMP_SLOTS = 3
STAMP_SCRIPT = ((0, 0), (1, 0), (2, 0), (3, 1), (0, 2), (1, 3), (0, 0), (2, 2), (3, 3),
                (1, 1), (0, 1), (2, 0), (3, 2), (1, 0))
STAMP_UNTOUCHED = -7  # what a ring cell holds until a stamp writes it
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
ND_TIER_LAUNCHES = 2  # the two tiers of the non-doubles tail at fast() widths
ND_REPLY_LAUNCHES = 15  # the non-double reply rolls
ND_LAUNCHES_PER_STEP_1PLY = ND_TIER_LAUNCHES
ND_LAUNCHES_PER_STEP_2PLY = ND_TIER_LAUNCHES + ND_REPLY_LAUNCHES  # the step's own moves + replies
FV_LAUNCHES_PER_STEP_2PLY = 22  # candidates + 15 + 6 reply rolls
DD_LAUNCHES_PER_STEP_1PLY = 1  # the doubles sub-batch
DD_LAUNCHES_PER_STEP_2PLY = 7  # the step's own moves + 6 reply dice
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
# phase 29: the mesh train step
TRAIN_MESH = ["--production", "--fused-rollout", "--data", "1", "--model", "1",
              "--mode", "continuous", "--td-mode", "side0", "--batch-games", str(B_PROD),
              "--steps-per-update", "64", "--updates", "3"]
MESH_KEYS = {"loss", "grad_norm", "td_abs", "v_mean", "episodes_done", "env_steps",
             "wins_regular", "wins_gammon", "wins_backgammon", "close_out_count",
             "prime_count", "reward_sum", "width_overflow_count"}
MPD_ARGS = ["--device", "cuda", "--widths", "full", "--batch", "4096", "--tp-batch", "1024",
            "--steps", "16", "--updates", "3"]


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
    from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value, stamp
    from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax
    from mlp_ppo_2ply_multi_tpu_torch.apps import evaluate
    from mlp_ppo_2ply_multi_tpu_torch.core import config as config_mod
    from mlp_ppo_2ply_multi_tpu_torch.core import graphs, tree
    from mlp_ppo_2ply_multi_tpu_torch.eval import arena
    from mlp_ppo_2ply_multi_tpu_torch.ops import take_rows
    from mlp_ppo_2ply_multi_tpu_torch.scripts import probe_take
    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen
    from mlp_ppo_2ply_multi_tpu_torch.scripts import trajectory_parity
    from mlp_ppo_2ply_multi_tpu_torch.parallel import distributed, sharding
    from mlp_ppo_2ply_multi_tpu_torch.utils import profiling, ring_buffer
    from mlp_ppo_2ply_multi_tpu_torch.scripts import multiprocess_distributed
    from mlp_ppo_2ply_multi_tpu_torch.io import remote
    from mlp_ppo_2ply_multi_tpu_torch.experimental import tiered
    from mlp_ppo_2ply_multi_tpu_torch.oracle import sampling
    from mlp_ppo_2ply_multi_tpu_torch.scripts import eval_curve, run_parity_trainer
    from mlp_ppo_2ply_multi_tpu_torch.scripts import stress_movegen2, twoply_decision_guard
    from mlp_ppo_2ply_multi_tpu_torch.scripts import bench, bench_r2_sweep, bench_spmd
    from mlp_ppo_2ply_multi_tpu_torch.scripts import bench_twoply, roofline, trace_attr
    from mlp_ppo_2ply_multi_tpu_torch.utils import cost
    from mlp_ppo_2ply_multi_tpu_torch.ops import dd_expand
    from mlp_ppo_2ply_multi_tpu_torch.ops import mlp_value

    return dict(
        dd=dd_expand, mlp=mlp_value,
        bench=bench, bench_twoply=bench_twoply, sweep=bench_r2_sweep, spmd=bench_spmd,
        roofline=roofline, trace_attr=trace_attr, cost=cost,
        sampling=sampling, stress=stress_movegen2, guard=twoply_decision_guard,
        curve=eval_curve, parity=run_parity_trainer,
        tiered=tiered,
        sharding=sharding, distributed=distributed, profiling=profiling, ring=ring_buffer,
        stamp=stamp,
        mpd=multiprocess_distributed, remote=remote,
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


def _plain_value(P):
    """``fused_value_plain`` in ``fused_value``'s place: the callers' valid
    mask, which Tesauro's net does not read, is dropped."""
    return lambda boards, flag, prm, valid=None: P["fv"].fused_value_plain(boards, flag, prm)


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
    kernels = (fv.KERNEL, nd.KERNEL, P["take"].KERNEL, P["stamp"].KERNEL, P["dd"].KERNEL,
               P["mlp"].KERNEL)
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
        f"{nd.KERNEL.lib.nd_tail_smem(nd.MAX_K)} B at K = {nd.MAX_K}; dd_expand "
        + ", ".join(f"{w}: {P['dd'].KERNEL.lib.dd_expand_game_bytes(*w)} B a game"
                    for w in DD_WIDTHS)
        + f"; mlp_value {P['mlp'].KERNEL.lib.mlp_value_smem()} B a CTA")
    mma = sass_mma_count(fv.KERNEL.build_info["path"], "fused_value_kernel")
    log(f"[2 build] tensor-core instructions (HMMA/HGMMA) in fused_value_kernel's SASS: "
        f"{'not measured (no cuobjdump)' if mma is None else mma}")
    if mma == 0:
        raise AssertionError("fused_value_kernel has no tensor-core instruction")


def phase_stamp(P, dev, card):
    """2: the stamp kernel (``ops.stamp.launch_kernel``) and its plain
    version (``stamp_plain``) run STAMP_SCRIPT into identical int64
    [STAMP_SLOTS, WIDTH] rings and cursors; the cursors, the rows' last
    columns (sequence x 8 + kind) and the untouched cells must be equal, and
    equal to the script's own bookkeeping, and the card's stamps rise in
    launch order. Two stamps around a spin read its CUDA-event time in
    nanoseconds (within 2% + 20 us); the four launches are queued behind a
    first spin, so that the host's time between them (the card idle between
    a stamp and an event) falls inside neither reading. Then one launch's
    device time, queued behind a spin."""
    S, PR = P["stamp"], P["profiling"]
    width = PR.WIDTH
    ring = torch.full((STAMP_SLOTS, width), STAMP_UNTOUCHED, dtype=torch.int64)
    cur = torch.zeros(1, dtype=torch.int64)
    dring, dcur = ring.clone().to(dev), cur.clone().to(dev)
    _sync(dev)
    writer, seq = {}, 0  # (slot, column) -> the launch that wrote it last
    n0 = S.KERNEL.launches
    for i, (col, close) in enumerate(STAMP_SCRIPT):
        S.launch_kernel(dring, dcur, col, close)
        S.stamp_plain(ring, cur, col, close)
        writer[(seq % STAMP_SLOTS, col)] = i
        if close:
            writer[(seq % STAMP_SLOTS, width - 1)] = i
            seq += 1
    _sync(dev)
    got = dring.cpu()
    untouched = torch.ones_like(got, dtype=torch.bool)
    for slot, col in writer:
        untouched[slot, col] = False
    order = sorted((i, slot, col) for (slot, col), i in writer.items() if col < width - 1)
    times = [int(got[slot, col]) for _, slot, col in order]
    out = dict(launches=S.KERNEL.launches - n0, cursor=int(dcur), plain_cursor=int(cur),
               rows=got[:, -1].tolist(), plain_rows=ring[:, -1].tolist(),
               untouched_equal=bool(torch.equal(got == STAMP_UNTOUCHED, untouched)
                                    and torch.equal(ring == STAMP_UNTOUCHED, untouched)),
               rising=all(0 < a <= b for a, b in zip(times, times[1:])))
    one = torch.full((1, width), STAMP_UNTOUCHED, dtype=torch.int64, device=dev)
    one_cur = torch.zeros(1, dtype=torch.int64, device=dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _sync(dev)
    torch.cuda._sleep(10**7)  # holds the card while the host queues the four launches
    S.launch_kernel(one, one_cur, 0, 0)
    e0.record()
    torch.cuda._sleep(10**7)  # ~5 ms at the H100's boost clock
    e1.record()
    S.launch_kernel(one, one_cur, 1, 1)
    _sync(dev)
    out.update(spin_events_ms=e0.elapsed_time(e1), spin_stamps_ms=int(one[0, 1] - one[0, 0]) / 1e6)
    out["ms_per_launch"] = PR.queued_ms_per_round(
        [lambda: S.launch_kernel(one, one_cur, 0, 1)], dev, rounds=1000)
    log(f"[2 stamp] kernel vs plain over {len(STAMP_SCRIPT)} stamps into {STAMP_SLOTS} slots: "
        f"{json.dumps(out)} {card}")
    if out["launches"] != len(STAMP_SCRIPT) or not (out["cursor"] == out["plain_cursor"] == seq):
        raise AssertionError(f"[2 stamp] launches or cursors: {out}")
    if out["rows"] != out["plain_rows"] or not out["untouched_equal"] or not out["rising"]:
        raise AssertionError(f"[2 stamp] the card's ring differs from the plain one: {got.tolist()} "
                             f"vs {ring.tolist()}")
    if abs(out["spin_stamps_ms"] - out["spin_events_ms"]) > 0.02 * out["spin_events_ms"] + 0.02:
        raise AssertionError(f"[2 stamp] stamps {out['spin_stamps_ms']} ms around a spin of "
                             f"{out['spin_events_ms']} ms by events: not nanoseconds")
    return out


def capture_candidates(P, params, state, cfg, dev, gen):
    """Run one production step and keep the (boards, flag) of each
    fused_value call, the real candidate boards of the main path, and the
    arguments of each nd_tail_fused call (the two tiers of its non-doubles
    tail)."""
    R, nd = P["rollout"], P["nd"]
    real, nd_real = R.fused_value, nd.nd_tail_fused
    seen, nd_seen = [], []

    def capture(boards, flag, prm, valid=None):
        seen.append((boards.clone(), torch.broadcast_to(flag, boards.shape[:-1]).clone()))
        return real(boards, flag, prm, valid)

    def nd_capture(*args):
        nd_seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return nd_real(*args)

    with _ValueFn(P, capture), _Swap(nd, "nd_tail_fused", nd_capture):
        state, _ = R.rollout_step(
            params, state, cfg.train.initial_temperature, cfg, True, gen=gen, device=dev
        )
    return state, seen, nd_seen


def phase_tiers_vs_plain(P, nd_seen, dev, card):
    """3b: B2 on the 1-ply step's two tier calls ([4096, K = 96] and the
    wide sub-batch [512, K = 288], a_max 448) against its plain version:
    bit-equal, ``after`` at every slot too."""
    worst, after_everywhere, kept, rows = nd_tail_vs_plain(P, nd_seen, dev)
    n_pre = nd_seen[0][0].sum(-1)
    log(f"[3b tiers vs plain] nd_tail: {[(a[0].shape[0], a[7], a[8]) for a in nd_seen]} "
        f"(rows, K, a_max), {rows} rows, {kept} kept slots; tier 1 n_pre mean "
        f"{float(n_pre.float().mean()):.2f}, {int((n_pre > nd_seen[0][7]).sum())} rows wider "
        f"than tier 1; max |diff| over keep/n_pre/pct/kpair and kept afterstates = {worst}; "
        f"after equal at every slot: {after_everywhere} {card}")
    if worst != 0 or not after_everywhere:
        raise AssertionError("[3b tiers vs plain] nd_tail differs from its plain version")
    return float(worst)


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
    R, Bd = P["rollout"], P["board"]
    temp = cfg.train.initial_temperature
    for _ in range(WARMUP):
        state, _ = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    P["stamp"].KERNEL.launches = 0  # the kernels line counts the stamps from here on
    since = P["profiling"].kernel_launches()
    t0 = time.perf_counter()
    ev0.record()
    ts = []
    for _ in range(STEPS):
        state, t = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
        ts.append(t)
    ev1.record()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches, nd_launches, dd_launches = _launched(P, since).values()
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
        "nd_tail_launches": nd_launches,
        "dd_expand_launches": dd_launches,
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
    if dd_launches != DD_LAUNCHES_PER_STEP_1PLY * STEPS:
        raise AssertionError(f"dd_expand launched {dd_launches} times in {STEPS} steps")
    if nd_launches != ND_LAUNCHES_PER_STEP_1PLY * STEPS:
        raise AssertionError(f"nd_tail launched {nd_launches} times in {STEPS} steps")
    if not stats["conservation_ok"] or not stats["values_finite"]:
        raise AssertionError("main path produced invalid boards or values")
    return state, stats


def phase_same_step(P, params, state, cfg, dev, gen, card):
    R, fv = P["rollout"], P["fv"]
    b = state.player.shape[0]
    noise = R.draw_noise(b, cfg, gen, dev)
    a_k, sm = decisions(P, params, state, noise, cfg)
    a_p, _ = decisions(P, params, state, noise, cfg, _plain_value(P))
    agree = a_k == a_p
    # rows with no legal move take no decision
    live = sm.count > 0
    n_dis = int((~agree & live).sum())
    temp = cfg.train.initial_temperature
    res_k = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    with _ValueFn(P, _plain_value(P)):
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
    inner = [("fused_value", R, "fused_value"), ("nd_tail", P["nd"], "nd_tail_fused")]
    state = stage_times(P, params, state, cfg, dev, gen, 8, stages, inner, "[7 time]", card)
    profile_steps(P, params, state, cfg, dev, gen, 4, step_ms, card, "[7 time]")


def _dev_t(e) -> float:
    """An event's own device time in us (the attribute's name differs
    between torch versions)."""
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def _device_events(prof):
    """The trace's device events (kernels, copies, sets), averaged by name.
    torch.profiler also gives each CPU op the device time of the kernels it
    launched, and each stage scope a device span over its kernels, so a sum
    over every event counts an eager kernel twice
    (``utils.profiling.device_events``)."""
    from mlp_ppo_2ply_multi_tpu_torch.utils.profiling import device_events

    return device_events(prof.key_averages())


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


def _queued_ms_per_round(fns, dev, rounds=10):
    """Device time per round of calling every fn once, the launches queued
    behind a spin kernel (``utils.profiling.queued_ms_per_round``)."""
    from mlp_ppo_2ply_multi_tpu_torch.utils.profiling import queued_ms_per_round

    return queued_ms_per_round(fns, dev, rounds)


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
        bd = P["fv"].bound(boards)
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


@contextlib.contextmanager
def _capturing(P, fv_module):
    """Within: the arguments of each nd_tail_fused call and the (boards,
    flag) of each ``fv_module.fused_value`` call, cloned as they run (the
    real inputs of a path's kernels), in two lists."""
    nd = P["nd"]
    nd_real, fv_real = nd.nd_tail_fused, fv_module.fused_value
    nd_seen, fv_seen = [], []

    def nd_capture(*args):
        nd_seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return nd_real(*args)

    def fv_capture(boards, flag, prm, valid=None):
        fv_seen.append((boards.clone(), torch.broadcast_to(flag, boards.shape[:-1]).clone()))
        return fv_real(boards, flag, prm, valid)

    with _Swap(nd, "nd_tail_fused", nd_capture), _Swap(fv_module, "fused_value", fv_capture):
        yield nd_seen, fv_seen


def capture_twoply_inputs(P, params, state, cfg, dev, gen):
    """Run one 2-ply step and keep the arguments of each nd_tail_fused and
    fused_value call: the real inputs of the 2-ply path's kernels."""
    with _capturing(P, P["X"]) as (nd_seen, fv_seen):
        state = twoply_steps(P, params, state, cfg, dev, gen, 1)
    return state, nd_seen, fv_seen


def nd_tail_vs_plain(P, nd_seen, dev):
    """nd_tail against its plain version on captured calls: (max |diff| over
    keep, n_pre, pct, kpair and the kept afterstates, whether ``after`` is
    equal at every slot too, kept slots, rows)."""
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
    return worst, after_everywhere, kept, rows


def phase_twoply_kernels_vs_plain(P, params, nd_seen, fv_seen, dev, gen, card):
    """Both kernels against their plain versions on one 2-ply step's real
    inputs. nd_tail must be bit-equal (after at kept slots); its max abs
    error is taken over every compared integer."""
    worst, after_everywhere, kept, rows = nd_tail_vs_plain(P, nd_seen, dev)
    n_pre = torch.cat([a[0].sum(-1) for a in nd_seen])
    shapes = collections.Counter((a[0].shape[0], a[7], a[8]) for a in nd_seen)
    log(f"[9 kernels vs plain 2-ply] nd_tail: {len(nd_seen)} calls, (rows, K, a_max) x calls "
        f"{sorted(shapes.items())}, "
        f"{rows} rows, {kept} kept slots, n_pre mean {float(n_pre.float().mean()):.2f} "
        f"max {int(n_pre.max())}; max |diff| over keep/n_pre/pct/kpair and kept "
        f"afterstates = {worst}; after equal at every slot: {after_everywhere} {card}")
    if worst != 0:
        raise AssertionError("nd_tail kernel differs from its plain version")
    worst_fv = phase_kernel_vs_plain(P, params, fv_seen, dev, gen, card, random_cases=False,
                                     tag="[9 kernels vs plain 2-ply] fused_value")
    return float(worst), worst_fv


def phase_twoply_main(P, params, state, cfg, dev, gen, card):
    R, Bd = P["rollout"], P["board"]
    temp = cfg.train.initial_temperature
    state = twoply_steps(P, params, state, cfg, dev, gen, WARMUP_2PLY)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    since = P["profiling"].kernel_launches()
    t0 = time.perf_counter()
    ev0.record()
    ts = []
    for _ in range(STEPS_2PLY):
        state, t = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
        ts.append(t)
    ev1.record()
    _sync(dev)
    wall = time.perf_counter() - t0
    fv_launches, nd_launches, dd_launches = _launched(P, since).values()
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
        "dd_expand_launches": dd_launches,
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
    if nd_launches != ND_LAUNCHES_PER_STEP_2PLY * STEPS_2PLY:
        raise AssertionError(f"nd_tail launched {nd_launches} times in {STEPS_2PLY} steps")
    if fv_launches != FV_LAUNCHES_PER_STEP_2PLY * STEPS_2PLY:
        raise AssertionError(f"fused_value launched {fv_launches} times in {STEPS_2PLY} steps")
    if dd_launches != DD_LAUNCHES_PER_STEP_2PLY * STEPS_2PLY:
        raise AssertionError(f"dd_expand launched {dd_launches} times in {STEPS_2PLY} steps")
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


def phase_twoply_kernel_timing(P, params, nd_seen, fv_seen, dev, card):
    """nd_tail per captured call: the kernel alone, the wrapper (operand
    layout + launch) and the plain version; fused_value at the 2-ply
    shapes likewise. Each summed over one step's launches."""
    per, nd_step = nd_tail_timing(P, nd_seen, dev)
    log(f"[14 kernel time 2-ply] nd_tail per launch: "
        f"{json.dumps({k: per[0][k] for k in ('rows', 'K', 'present_per_row', 'child_rows_per_row', 'bytes', 'ops', 'bytes_ms', 'ops_ms', 'bound_ms')})}; "
        f"event-timed loop ms per call {[round(r['events_ms'], 4) for r in per]} {card}")
    log(f"[14 kernel time 2-ply] nd_tail one step: {json.dumps(nd_step)} {card}")
    fv_step = phase_kernel_timing(P, params, fv_seen, dev, card, "[14 kernel time 2-ply] fused_value", 10)
    fv_step["dense_product_ms"] = dense_product_ms(P, params, fv_seen[1][0], dev, card)
    return nd_step, fv_step


def nd_tail_timing(P, nd_seen, dev):
    """Per captured nd_tail call, CUDA events around loops of the kernel
    alone, the wrapper (operand layout + launch) and the plain version,
    with the bound (``nd_tail.bound``); and their sums over the calls, the
    kernel's device time from its launches queued ahead of the card."""
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
                        **nd.bound(args[0], K)))
    return per, _step_sums(per, _queued_ms_per_round(kernel_calls, dev))


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
    td, R = P["td"], P["rollout"]
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
            since = P["profiling"].kernel_launches()
            t0 = time.perf_counter()
            rc = P["train"].main(argv)
            _sync(dev)
            wall = time.perf_counter() - t0
            launches = _launched(P, since)
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
    if stats["launches"] != {"fused_value": 2 * steps,
                             "nd_tail": ND_LAUNCHES_PER_STEP_1PLY * steps,
                             "dd_expand": DD_LAUNCHES_PER_STEP_1PLY * steps}:
        raise AssertionError(f"[16 train 1-ply] launched {stats['launches']} in {steps} steps")
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
            "nd_tail": ND_LAUNCHES_PER_STEP_2PLY * steps,
            "dd_expand": DD_LAUNCHES_PER_STEP_2PLY * steps}
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
    if stats["launches"] != {"fused_value": 2 * 300, "nd_tail": ND_LAUNCHES_PER_STEP_1PLY * 300,
                             "dd_expand": DD_LAUNCHES_PER_STEP_1PLY * 300}:
        raise AssertionError(f"[18 train sync] launched {stats['launches']} in 300 steps")
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
    R, VE = P["rollout"], P["vec_env"]
    temp = cfg.train.initial_temperature
    out = []
    for graphed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = VE.reset(batch, gen, device=dev)
        since = P["profiling"].kernel_launches()
        if graphed:
            out.append(R.rollout_chunked(params, state, temp, cfg, steps, chunk=chunk,
                                         gen=gen, device=dev))
        else:
            out.append(R.rollout_loop(params, state, temp, cfg, steps, True, gen=gen,
                                      device=dev))
        _sync(dev)
    return out[0], out[1], _launched(P, since)


def _launched(P, since, names=("fused_value", "nd_tail", "dd_expand")):
    """Each kernel's launches since the launch registry's snapshot ``since``
    (``profiling.kernel_launches``), by name."""
    now = P["profiling"].kernel_launches()
    return {n: now.get(n, 0) - since.get(n, 0) for n in names}


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
    _gate(launches["dd_expand"], DD_LAUNCHES_PER_STEP_1PLY * steps, "graphed 1-ply dd_expand")
    _gate(launches["nd_tail"], ND_LAUNCHES_PER_STEP_1PLY * steps, "graphed 1-ply nd_tail")
    start = td.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)._replace(
        params=params, opt_state=td.init_adam(params))
    trained, metrics = td.update(start, graphed[1], cfg, dev)
    if trained.params["w1"] is not params["w1"]:
        raise AssertionError("td.update did not update the params in place")
    eager2, graphed2, launches2 = eager_and_graphed(P, params, cfg, B_PROD, steps, chunk, 12, dev)
    dv2 = compare_rollouts(eager2, graphed2, "graphed vs eager 1-ply after an update")
    _gate(launches2["fused_value"], 2 * steps, "graphed 1-ply fused_value after an update")
    _gate(launches2["dd_expand"], DD_LAUNCHES_PER_STEP_1PLY * steps,
          "graphed 1-ply dd_expand after an update")
    _gate(launches2["nd_tail"], ND_LAUNCHES_PER_STEP_1PLY * steps,
          "graphed 1-ply nd_tail after an update")
    # the update moved the values, so a graph still reading the old packed
    # G would have taken other decisions
    boards, flag = eager2[1].packed_board[0], 1 - eager2[1].player[0]
    before = P["fv"].fused_value_plain(
        boards, flag, P["value_net"].load_checkpoint(str(CKPT), device=dev))
    moved = float((P["fv"].fused_value_plain(boards, flag, params) - before).abs().max())
    stats = dict(batch=B_PROD, steps=steps, chunk=chunk, launches=launches["fused_value"],
                 launches_after_update=launches2["fused_value"],
                 dd_launches=launches["dd_expand"] + launches2["dd_expand"],
                 nd_launches=launches["nd_tail"] + launches2["nd_tail"], max_abs_dv=dv,
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
                     "nd_tail": ND_LAUNCHES_PER_STEP_2PLY * steps,
                     "dd_expand": DD_LAUNCHES_PER_STEP_2PLY * steps}, "graphed 2-ply")
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
    R, VE = P["rollout"], P["vec_env"]
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    out = {}
    for name, cfg, batch, steps, chunks, per_step in (
        ("1ply", production_config(P), B_PROD, GRAPH_STEPS_1PLY, (1, 4, 16),
         {"fused_value": 2, "nd_tail": ND_LAUNCHES_PER_STEP_1PLY,
          "dd_expand": DD_LAUNCHES_PER_STEP_1PLY}),
        ("2ply", twoply_config(P), B_TWOPLY, STEPS_2PLY, (1, 4),
         {"fused_value": FV_LAUNCHES_PER_STEP_2PLY, "nd_tail": ND_LAUNCHES_PER_STEP_2PLY,
          "dd_expand": DD_LAUNCHES_PER_STEP_2PLY}),
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
            since = P["profiling"].kernel_launches()
            t0 = time.perf_counter()
            state, traj = R.rollout_chunked(params, state, temp, cfg, steps, chunk=chunk,
                                            gen=gen, device=dev)
            _sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = _launched(P, since)
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
                   plan=T.plan(n, w, k, c), **P["take"].bound(boards, idx))
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
    out["nd_tail_k576"] = nd_one_launch(P, seen[0], dev, "[25] nd_tail at K = 576")
    log(f"[25 eval graph vs eager] nd_tail at K = 576 on the eval path, bit-equal to its plain "
        f"version: {json.dumps(out['nd_tail_k576'])} {card}")
    return out


def nd_one_launch(P, args, dev, what):
    """One captured nd_tail call: the kernel bit-equal to its plain version
    (after at kept slots), then one launch timed queued ahead of the card
    (twice, around the plain version's time), with its bound."""
    nd = P["nd"]
    K, a_max = args[7], args[8]
    got, want = nd.nd_tail_fused(*args), nd.nd_tail_plain(*args)
    _sync(dev)
    keep = want[1]
    if not (torch.equal(got[1], want[1])
            and all(torch.equal(x, y) for x, y in zip(got[2:], want[2:]))
            and torch.equal(got[0][keep], want[0][keep])):
        raise AssertionError(f"{what} differs from its plain version")
    ops = nd.kernel_operands(*args[:7], K)
    kern = functools.partial(nd.launch_kernel, *ops, K, a_max)
    k1 = _queued_ms_per_round([kern], dev)
    plain_ms = _time_ms(lambda: nd.nd_tail_plain(*args), dev, 5)
    k2 = _queued_ms_per_round([kern], dev)
    bound = nd.bound(args[0], K)
    return dict(ms_per_launch=(k1 + k2) / 2, runs_ms=[k1, k2], plain_ms=plain_ms,
                **bound, bound_share=bound["bound_ms"] / ((k1 + k2) / 2))


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


# ---------------------------------------------------------------------------
# the mesh train step
# ---------------------------------------------------------------------------


def _first_step_recorder(P, kept):
    """``sharding.make_train_step`` whose step keeps, at its first call, what
    the single-card loop needs to redo that update (the config, the state,
    the games, the generator's state), the trajectory it rolled and the
    state after it."""
    S, real_make = P["sharding"], P["sharding"].make_train_step

    def make(mesh, cfg, num_steps, tp=False):
        step = real_make(mesh, cfg, num_steps, tp=tp)

        def first(state, env_state, gen=None, noise=None):
            if kept:
                return step(state, env_state, gen, noise)
            dev = state.params["w1"].device
            kept.update(cfg=S._tp_config(cfg, tp), steps=num_steps, gen=gen.get_state(),
                        state=_clone_state(P, state, dev),
                        env=P["tree"].tmap(torch.clone, env_state))
            trajs = []
            untap = P["mpd"]._tap(trajs)
            try:
                out = step(state, env_state, gen, noise)
            finally:
                untap()
            kept.update(traj=trajs[0], after=_clone_state(P, out[0], dev))
            return out
        return first
    return make


def phase_mesh_cli(P, dev, card, train1):
    """29a: ``apps.train.main`` with --production --fused-rollout --data 1
    --model 1 at B = 4096, 3 updates of 64 steps, in-process on a one-rank
    NCCL group: 3 finite metrics lines with JAX's mesh keys, exactly 2 x 64
    fused_value launches an update (by replay), and the first update redone
    by the single-card loop (``rollout_chunked`` + ``td.update``) from the
    same state, games and generator: the integer trajectory bit-equal,
    params and Adam's moments at phase 15's tolerances."""
    R, td, S = P["rollout"], P["td"], P["sharding"]
    kept, update_ms, reduce_ms, reduce_by_update = {}, [], [], []
    timed_update = _synced_timer(S._update, update_ms, dev)

    def update(*args, **kwargs):  # the update's all-reduces, summed
        start = len(reduce_ms)
        out = timed_update(*args, **kwargs)
        reduce_by_update.append(sum(reduce_ms[start:]))
        return out

    with _Swap(S, "make_train_step", _first_step_recorder(P, kept)), \
            _Swap(S, "_update", update), \
            _Swap(S, "_all_reduce", _synced_timer(S._all_reduce, reduce_ms, dev)):
        stats, lines, _, _ = run_train(P, TRAIN_MESH, dev, "[29 mesh]", card)
    if torch.distributed.is_initialized():
        raise AssertionError("[29 mesh] the CLI left its process group behind")
    steps = 64 * stats["updates"]
    if stats["updates"] != 3:
        raise AssertionError(f"[29 mesh] {stats['updates']} metrics lines")
    for ln in lines:
        if not MESH_KEYS <= set(ln) or not all(math.isfinite(v) for v in ln.values()):
            raise AssertionError(f"[29 mesh] metrics line {ln}")
    if stats["launches"] != {"fused_value": 2 * steps,
                             "nd_tail": ND_LAUNCHES_PER_STEP_1PLY * steps,
                             "dd_expand": DD_LAUNCHES_PER_STEP_1PLY * steps}:
        raise AssertionError(f"[29 mesh] launched {stats['launches']} in {steps} steps")
    cfg = kept["cfg"]
    gen = torch.Generator(device=dev)
    gen.set_state(kept["gen"])
    start = kept["state"]
    temp = td.temperature(start.version, cfg)
    _, traj = R.rollout_chunked(start.params, kept["env"], temp, cfg, kept["steps"], chunk=4,
                                gen=gen, device=dev)
    for f in P["mpd"].EXACT_FIELDS:
        if not torch.equal(getattr(traj, f), getattr(kept["traj"], f)):
            raise AssertionError(f"[29 mesh] trajectory field {f}: mesh step vs single loop")
    single, _ = td.update(start, traj, cfg, dev)
    err = compare_states(kept["after"], single, "[29 mesh] mesh step vs single loop")
    P["graphs"].clear_graphs()
    n = stats["updates"]
    out = dict(updates=n, launches=stats["launches"],
               ms_per_update=stats["ms_per_update"],
               update_ms=update_ms, all_reduces_per_update=len(reduce_ms) / n,
               # the first update's first all-reduce sets up NCCL's communicator
               all_reduce_ms_by_update=reduce_by_update,
               env_steps_per_s=B_PROD * 64 / (stats["ms_per_update"] / 1e3),
               phase16_ms_per_update=train1["ms_per_update"], rollout_ms=stats["rollout_ms"],
               wall_s=stats["wall_s"], peak_mem_gib=stats["peak_mem_gib"],
               loss=stats["loss"], first_update_vs_single=err)
    log(f"[29 mesh] CLI at 1 x 1 on NCCL: {json.dumps(out)} {card}")
    return out


def _synced_timer(fn, into, dev):
    """``fn`` with the device synchronised before and after each call, its
    ms appended to ``into``."""
    def run(*args, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(dev)
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def compare_states(a, b, what):
    """Params within PARAM_ATOL, Adam's moments at phase 15's tolerances,
    version and Adam count equal. Returns the largest errors."""
    err = {"params_abs": max(float((a.params[k] - b.params[k]).abs().max()) for k in b.params)}
    if err["params_abs"] > PARAM_ATOL:
        raise AssertionError(f"{what}: params differ by {err['params_abs']}")
    for name in ("mu", "nu"):
        for k in b.params:
            x, y = getattr(a.opt_state, name)[k], getattr(b.opt_state, name)[k]
            lim = MOMENT_RTOL * y.abs() + MOMENT_FLOOR * float(y.abs().max())
            if not bool(((x - y).abs() <= lim).all()):
                raise AssertionError(f"{what}: Adam {name} {k} differs")
        err[f"{name}_abs"] = max(float((getattr(a.opt_state, name)[k]
                                        - getattr(b.opt_state, name)[k]).abs().max())
                                 for k in b.params)
    if int(a.version) != int(b.version) or int(a.opt_state.count) != int(b.opt_state.count):
        raise AssertionError(f"{what}: counters differ")
    return err


def phase_mesh_world2(card):
    """29b: ``scripts/multiprocess_distributed.py --device cuda``: two gloo
    ranks on card 0 run make_train_step on a (2, 1) mesh at a global
    B = 4096 (``Config()``, f32, 3 updates of 16 steps) against one rank on
    the same games and injected noise, then a (1, 2) tp update at
    B = 1024 against the update without tp and JAX's tp rule. Exit 0 and
    its result line, or the phase fails."""
    cmd = [sys.executable, "-m", "mlp_ppo_2ply_multi_tpu_torch.scripts.multiprocess_distributed",
           *MPD_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    if proc.returncode != 0 or not lines or not json.loads(lines[-1]).get("ok"):
        raise AssertionError(f"[29 mesh world 2] exit {proc.returncode}: {proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    res = json.loads(lines[-1])
    log(f"[29 mesh world 2] gloo ranks on cuda:0 vs one rank, {wall:.1f} s: "
        f"{json.dumps(res)} {card}")
    return dict(res, wall_s=wall)


def phase_remote_refusal(P, card):
    """29c: ``apps.train --remote-dir memory://x`` exits 2 naming fsspec
    where fsspec does not import (made unimportable for the call, whether
    or not this machine has it), before it writes anything."""
    native = P["remote"].available()
    err = io.StringIO()
    saved = sys.modules.get("fsspec")
    sys.modules["fsspec"] = None
    code = 0
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stderr(err):
            try:
                P["train"].main(["--device", "cuda", "--remote-dir", "memory://x",
                                 "--checkpoint-dir", f"{tmp}/ck", "--metrics-dir",
                                 f"{tmp}/runs"])
            except SystemExit as e:
                code = e.code
            wrote = Path(tmp, "runs").exists()
    finally:
        if saved is None:
            del sys.modules["fsspec"]
        else:
            sys.modules["fsspec"] = saved
    msg = err.getvalue().strip().splitlines()[-1]
    if code != 2 or "fsspec" not in msg or wrote:
        raise AssertionError(f"[29 remote] exit {code}, wrote {wrote}: {msg}")
    log(f"[29 remote] --remote-dir without fsspec: exit 2, {msg!r} (fsspec here: {native}) {card}")


def phase_ring_and_profile(P, dev, gen, card):
    """29d: the ring buffer on the card (10 pushes of [4096, 52] boards and
    values into 8 slots and 64 samples by a CUDA generator, under
    sync-debug "error"; a push captured in a CUDA graph and replayed), and
    the tracer's record of a graphed 1-ply rollout (16 steps, chunk 4,
    B = 4096): every row read (none lost or stale: the host's count of the
    graph's rows is the card's cursor), and the launch wait plus the
    stamped steps' mean stage ms times 16 agrees with CUDA events around the
    call within 10%."""
    RB, PR, R = P["ring"], P["profiling"], P["rollout"]
    mk = lambda: {"boards": torch.randint(0, 16, (B_PROD, 52), generator=gen, device=dev
                                          ).to(torch.int8),
                  "value": torch.rand(B_PROD, generator=gen, device=dev)}
    slices = [mk() for _ in range(10)]
    ring = RB.init(slices[0], 8)
    _sync(dev)
    with syncs_raise(dev):
        for sl in slices:
            RB.push(ring, sl)
        idx = RB.sample_indices(ring, gen, 64)
        got = RB.take(ring, idx)
    _sync(dev)
    held = {i % 8: sl for i, sl in enumerate(slices)}
    ok = int(ring.cursor) == 2 and int(ring.filled) == 8 and all(
        torch.equal(ring.store[k][i], sl[k]) for i, sl in held.items() for k in sl)
    ok = ok and bool(((idx >= 0) & (idx < 8)).all()) and all(
        torch.equal(got[k], ring.store[k][idx]) for k in got)
    ring2 = RB.init(slices[0], 4)
    static = {k: v.clone() for k, v in slices[0].items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        RB.push(ring2, static)  # the warm-up runs: cursor 1
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        RB.push(ring2, static)
    for _ in range(3):
        graph.replay()
    _sync(dev)
    ok = ok and int(ring2.cursor) == 0 and int(ring2.filled) == 4
    if not ok:
        raise AssertionError("[29 ring] pushes, samples or the graphed push are wrong")
    del slices, ring, ring2, graph

    cfg = production_config(P)
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    state = P["vec_env"].reset(B_PROD, gen, device=dev)

    def graphed_rollout():
        return R.rollout_chunked(params, state, 1.0, cfg, 16, chunk=4, gen=gen, device=dev)

    graphed_rollout()  # captures the graph
    pairs = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graphed_rollout()
        e1.record()
        PR.trace_flush()  # no learner follows: close the update's record
        _sync(dev)
        rec = PR.trace_records()[-1]
        if (rec["lost_rows"], rec["stale_rows"], len(rec["stages"])) != (0, 0, 4) \
                or rec["launch_wait_ms"] is None:
            raise AssertionError(f"[29 ring] the tracer's record of 4 chunks (a stamped step "
                                 f"each, a launch row) is not whole: {rec}")
        step_ms = [sum(st.values()) for st in rec["stages"]]
        traced = rec["launch_wait_ms"] + sum(step_ms) / len(step_ms) * 16
        pairs.append((traced, e0.elapsed_time(e1)))
    traced_ms, ev_ms = sorted(pairs)[2]
    ops = PR.device_op_times(graphed_rollout)
    P["graphs"].clear_graphs()
    out = dict(traced_ms=traced_ms, events_ms=ev_ms, rel=abs(traced_ms - ev_ms) / ev_ms,
               pairs_ms=pairs, device_ops=len(ops), device_ms=sum(ops.values()),
               top_ops={k[:60]: v for k, v in list(ops.items())[:5]})
    log(f"[29 ring] ring buffer: 10 pushes, 64 samples, no host sync; a push captured "
        f"and replayed 3 times; the tracer's rollout record (launch wait + stamped steps' "
        f"stage ms x 16) vs events: {json.dumps(out)} {card}")
    if out["rel"] > 0.10:
        raise AssertionError(f"[29 ring] traced {traced_ms:.3f} ms vs events {ev_ms:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# the JAX package's rejected experiments (the tiered pipeline, the Gram
# dedup, the scan scorer, the value-first replies) and the probe's XLA modes
# ---------------------------------------------------------------------------

B_TIERED_SMALL = 256  # phase 30a: card vs CPU
TIERED_STEPS = 8
TIERED_GRAPH_STEPS = 16
TRAIN_TIERED = ["--production", "--tiered", "--mode", "continuous", "--td-mode", "side0",
                "--batch-games", str(B_PROD), "--steps-per-update", "64", "--updates", "2"]
GRAM_STEPS = 4
SCAN_STEPS = 3
VALUE_FIRST_M = 16
# tests/test_torch_twoply_scan.py: the scores are f32 sums of 21 terms of
# magnitude below ~1, of either sign (the head is linear), added in another
# order, so a relative bound alone fails near 0
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6
VF_RTOL, VF_ATOL = 1e-6, 1e-7  # JAX tests/test_twoply_valuefirst.py:134


def tiered_config(P):
    """The config ``apps.train`` builds for --production --tiered --td-mode
    side0: Config.production() with the tiered pipeline, nd_tier 96 and
    dd_tier (48, 96, 96)."""
    T = P["train"]
    return T.build_config(T._parser().parse_args(["--production", "--tiered",
                                                  "--td-mode", "side0"]))


def capture_tiered_inputs(P, params, state, cfg, dev, gen):
    """One tiered step; the (boards, flag) of its two fused_value calls and
    the arguments of its nd_tail_fused call (the wide plane's tail)."""
    with _capturing(P, P["tiered"]) as (nd_seen, fv_seen):
        state, _ = P["rollout"].rollout_step(params, state, cfg.train.initial_temperature,
                                             cfg, True, gen=gen, device=dev)
    return state, fv_seen, nd_seen


def timed_steps(P, params, state, cfg, dev, gen, n, noises=None):
    """``n`` eager steps timed by CUDA events, each kernel's launches
    counted from 0 just before them; (state, trajectory, ms a step,
    launches)."""
    R, fv, nd = P["rollout"], P["fv"], P["nd"]
    temp = cfg.train.initial_temperature
    _sync(dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fv.KERNEL.launches = nd.KERNEL.launches = 0
    e0.record()
    ts = []
    for i in range(n):
        nz = None if noises is None else noises[i]
        state, t = R.rollout_step(params, state, temp, cfg, True, noise=nz, gen=gen, device=dev)
        ts.append(t)
    e1.record()
    _sync(dev)
    launches = {"fused_value": fv.KERNEL.launches, "nd_tail": nd.KERNEL.launches}
    traj = R.Transition(*(torch.stack(xs) for xs in zip(*ts)))
    return state, traj, e0.elapsed_time(e1) / n, launches


def phase_tiered(P, dev, gen, card, train1):
    """30: the tiered 1-ply step (``train --tiered``'s config) at B = 4096:
    (a) card vs CPU at B = 256, every Tiered field bit-equal (boards at
    valid slots) and the step's integer state on agreeing decisions; (b)
    fused_value at [4096, 96] and [512, 448] and nd_tail at [512, K = 288]
    on one step's real inputs against their plain versions (nd_tail
    bit-equal) and timed with their bounds; (c) timed eager steps, exactly
    2 fused_value and 1 nd_tail launches a step, then two steps under
    torch.profiler (device busy, idle share); (d) rollout_chunked (chunk
    4, 16 steps) bit-equal to rollout_loop; (e) ``apps.train.main`` with
    --production --tiered, 2 updates of 64 steps: finite loss, launches
    gated, ms an update beside phase 16's (``train1``)."""
    R, VE, XT, fv, nd, Bd = (P["rollout"], P["vec_env"], P["tiered"], P["fv"], P["nd"],
                             P["board"])
    cfg = tiered_config(P)
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    temp = cfg.train.initial_temperature
    out = {}

    # (a) card vs CPU
    state = VE.reset(B_TIERED_SMALL, gen, device=dev)
    for _ in range(4):
        state, _ = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
    noise = R.draw_noise(B_TIERED_SMALL, cfg, gen, dev)
    cpu = torch.device("cpu")
    state_c, noise_c = _to_cpu(state), _to_cpu(noise)
    params_c = {k: v.cpu() for k, v in params.items()}
    ti_g = XT.legal_moves_tiered(state.board, state.player, state.dice, cfg.movegen)
    ti_c = XT.legal_moves_tiered(state_c.board, state_c.player, state_c.dice, cfg.movegen)
    for name in ("narrow_valid", "wide_player", "in_wide", "wide_slot", "count", "overflow"):
        if not torch.equal(getattr(ti_g, name).cpu(), getattr(ti_c, name)):
            raise AssertionError(f"[30 tiered] legal_moves_tiered {name} differs card vs CPU")
    for f in ("valid", "count", "overflow"):
        if not torch.equal(getattr(ti_g.wide, f).cpu(), getattr(ti_c.wide, f)):
            raise AssertionError(f"[30 tiered] legal_moves_tiered wide.{f} differs card vs CPU")
    m, w = ti_c.narrow_valid, ti_c.wide.valid
    if not (torch.equal(ti_g.narrow_boards.data.cpu()[m], ti_c.narrow_boards.data[m])
            and torch.equal(ti_g.wide.boards.data.cpu()[w], ti_c.wide.boards.data[w])):
        raise AssertionError("[30 tiered] legal_moves_tiered boards differ card vs CPU")
    ch_g, _ = XT.chosen_tiered(params, state, ti_g, noise.gumbel_t1, noise.gumbel_t2,
                               torch.tensor(temp, device=dev), cfg)
    ch_c, _ = XT.chosen_tiered(params_c, state_c, ti_c, noise_c.gumbel_t1, noise_c.gumbel_t2,
                               torch.tensor(temp), cfg)
    live = ti_c.count > 0
    agree = (ch_g.data.cpu() == ch_c.data).all(-1) | ~live
    res_g = R.rollout_step(params, state, temp, cfg, True, noise=noise, device=dev)
    res_c = R.rollout_step(params_c, state_c, temp, cfg, True, noise=noise_c, device=cpu)
    compare_steps(P, res_g, res_c, agree, "[30 tiered] card vs CPU step")
    n_dis = int((~agree).sum())
    out["card_vs_cpu"] = dict(batch=B_TIERED_SMALL, wide_rows=int(ti_c.in_wide.sum()),
                              disagreements=n_dis, live=int(live.sum()))
    log(f"[30 tiered] card vs CPU at B={B_TIERED_SMALL}: every Tiered field bit-equal; "
        f"{json.dumps(out['card_vs_cpu'])} {card}")
    if n_dis > (1 - AGREE_MIN) * int(live.sum()):
        raise AssertionError("[30 tiered] card and CPU decisions disagree")
    del state_c, noise_c, ti_c, res_c

    # (b) the kernels on one step's real inputs at B = 4096
    state = VE.reset(B_PROD, gen, device=dev)
    for _ in range(2):
        state, _ = R.rollout_step(params, state, temp, cfg, True, gen=gen, device=dev)
    state, fv_seen, nd_seen = capture_tiered_inputs(P, params, state, cfg, dev, gen)
    wb = B_PROD // cfg.movegen.tiered_wide_div
    shapes = [tuple(b.shape[:-1]) for b, _ in fv_seen]
    nd_shapes = [(a[0].shape[0], a[7]) for a in nd_seen]
    if shapes != [(B_PROD, 96), (wb, 448)] or nd_shapes != [(wb, 288)]:
        raise AssertionError(f"[30 tiered] unexpected kernel shapes {shapes} {nd_shapes}")
    fv_err = phase_kernel_vs_plain(P, params, fv_seen, dev, gen, card, random_cases=False,
                                   tag="[30 tiered] fused_value")
    nd_err, after_all, kept, rows = nd_tail_vs_plain(P, nd_seen, dev)
    log(f"[30 tiered] nd_tail at [{wb}, K = 288]: max |diff| {nd_err} over keep/n_pre/pct/"
        f"kpair and {kept} kept afterstates; after equal at every slot: {after_all} {card}")
    if nd_err:
        raise AssertionError("[30 tiered] nd_tail differs from its plain version")
    fv_time = phase_kernel_timing(P, params, fv_seen, dev, card, "[30 tiered] fused_value", 10)
    nd_per, nd_time = nd_tail_timing(P, nd_seen, dev)
    nd_row = {**nd_per[0], "ms": nd_time["ms"]}
    log(f"[30 tiered] nd_tail one launch at [{wb}, K = 288]: {json.dumps(nd_row)} {card}")
    out.update(fv_err=fv_err, nd_err=float(nd_err), fv_time=fv_time, nd_time=nd_row)
    del fv_seen, nd_seen

    # (c) timed eager steps
    state, traj, ms, launches = timed_steps(P, params, state, cfg, dev, gen, TIERED_STEPS)
    _gate(launches, {"fused_value": 2 * TIERED_STEPS, "nd_tail": TIERED_STEPS},
          "[30 tiered] eager steps")
    ok = bool(Bd.checker_conservation_ok(state.board).all() & torch.isfinite(traj.value).all())
    out["eager"] = dict(batch=B_PROD, steps=TIERED_STEPS, ms_per_step=ms, launches=launches,
                        env_steps_per_s=B_PROD / (ms / 1e3),
                        overflow_count=int(traj.overflow.sum()),
                        mean_legal_moves=float(traj.num_moves[traj.recorded].float().mean()),
                        checkers_and_values_ok=ok)
    log(f"[30 tiered] eager steps: {json.dumps(out['eager'])} {card}")
    if not ok:
        raise AssertionError("[30 tiered] invalid boards or values")
    # the device's busy time beside the host's: what the eager step waits on
    profile_steps(P, params, state, cfg, dev, gen, 2, ms, card, "[30 tiered]")

    # (d) graphed vs eager
    P["graphs"].clear_graphs()
    eager, graphed, launches = eager_and_graphed(P, params, cfg, B_PROD, TIERED_GRAPH_STEPS, 4,
                                                 30, dev)
    dv = compare_rollouts(eager, graphed, "[30 tiered] graphed vs eager")
    # (the tiered doubles' launches are logged, not gated)
    _gate({k: launches[k] for k in ("fused_value", "nd_tail")},
          {"fused_value": 2 * TIERED_GRAPH_STEPS, "nd_tail": TIERED_GRAPH_STEPS},
          "[30 tiered] graphed")
    out["graph"] = dict(steps=TIERED_GRAPH_STEPS, chunk=4, launches=launches, max_abs_dv=dv)
    log(f"[30 tiered] rollout_chunked bit-equal to rollout_loop: {json.dumps(out['graph'])} "
        f"{card}")
    P["graphs"].clear_graphs()
    del eager, graphed

    # (e) the training CLI
    stats, lines, _, _ = run_train(P, TRAIN_TIERED, dev, "[30 tiered train]", card)
    spu = int(TRAIN_TIERED[TRAIN_TIERED.index("--steps-per-update") + 1])
    steps = spu * stats["updates"]
    want = {"fused_value": 2 * steps, "nd_tail": steps}
    if stats["updates"] != 2 or not all(math.isfinite(x) for x in stats["loss"]):
        raise AssertionError(f"[30 tiered train] metrics lines {stats['updates']} {stats['loss']}")
    _gate({k: stats["launches"][k] for k in want}, want, "[30 tiered train]")
    stats.update(**update_breakdown(stats, spu),
                 phase16_ms_per_update=train1["ms_per_update"])
    out["train"] = stats
    log(f"[30 tiered train] {json.dumps(stats)}")
    return out


def phase_gram(P, dev, gen, card):
    """31: the production 1-ply step at B = 4096 with ``nd_sig_dedup=False``
    (the Gram dedup) and with signatures, from the same state and noise:
    identical decisions, split planes and integer state; ms a step of each
    over the same noise."""
    R, VE = P["rollout"], P["vec_env"]
    cfg = production_config(P)
    gram = cfg.replace(movegen=dataclasses.replace(cfg.movegen, nd_sig_dedup=False))
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    state = VE.reset(B_PROD, gen, device=dev)
    for _ in range(4):
        state, _ = R.rollout_step(params, state, 1.0, cfg, True, gen=gen, device=dev)
    noise = R.draw_noise(B_PROD, cfg, gen, dev)
    a_s, sm_s = decisions(P, params, state, noise, cfg)
    a_g, sm_g = decisions(P, params, state, noise, gram)
    for f in ("valid", "count", "overflow", "nd_keep", "ndw_keep"):
        if not torch.equal(getattr(sm_s, f), getattr(sm_g, f)):
            raise AssertionError(f"[31 gram] legal_moves_split {f} differs from the sig dedup")
    res_s = R.rollout_step(params, state, 1.0, cfg, True, noise=noise, device=dev)
    res_g = R.rollout_step(params, state, 1.0, gram, True, noise=noise, device=dev)
    compare_rollouts(res_s, res_g, "[31 gram] gram vs sig step")
    if not torch.equal(a_s, a_g):
        raise AssertionError("[31 gram] decisions differ")
    noises = [R.draw_noise(B_PROD, cfg, gen, dev) for _ in range(GRAM_STEPS)]
    out = {}
    for c in (cfg, gram):  # warm-up
        timed_steps(P, params, state, c, dev, gen, 1, noises)
    for name, c in (("sig", cfg), ("gram", gram), ("gram_again", gram), ("sig_again", cfg)):
        _, _, ms, launches = timed_steps(P, params, state, c, dev, gen, GRAM_STEPS, noises)
        # B2 dedups by signature only: the Gram dedup's tiers run the plain tail
        nd_per_step = 0 if name.startswith("gram") else ND_LAUNCHES_PER_STEP_1PLY
        _gate(launches, {"fused_value": 2 * GRAM_STEPS, "nd_tail": nd_per_step * GRAM_STEPS},
              f"[31 gram] {name}")
        out[name] = dict(ms_per_step=ms, launches=launches)
    log(f"[31 gram] B={B_PROD}: decisions, planes and integer state identical; ms a step "
        f"(eager, same noise): {json.dumps(out)} {card}")
    return out


def scan_config(P, **twoply):
    """Config.production() with td_mode "side0" and the 2-ply scorer at
    ``TwoPlyConfig(enabled=True)``'s uniform reply widths."""
    cfg = production_config(P)
    return cfg.replace(twoply=P["cfg"].TwoPlyConfig(enabled=True, **twoply))


def twoply_candidates(P, params, state, cfg):
    """The top-k candidate boards ``select_action_2ply`` reranks, and the
    replying player."""
    X, MG = P["X"], P["movegen"]
    moves = MG.legal_moves(state.board, state.player, state.dice, cfg.movegen)
    v = X.oriented_values(params, moves.boards, state.player[..., None], cfg)
    _, topi = X.topk_small(torch.where(moves.valid, v, -1e9), cfg.twoply.top_k_candidates)
    return MG.board_take(moves.boards, topi), 1 - state.player


def scorer_kernels_vs_plain(P, params, cfg, nd_seen, fv_seen, want, dev, gen, card, tag):
    """The kernels of one scorer call against their plain versions on its
    captured inputs: each nd_tail call bit-equal, each fused_value call
    within KERNEL_TOL, at the shapes the scorer gives them (C = roll_chunk
    rolls a call: nd_tail at [C x B x top_k rows, K = reply_a_max],
    fused_value at [C, B, top_k, reply_a_max]), gated; then one launch of
    each timed with its bound."""
    tp = cfg.twoply
    C = tp.roll_chunk
    rows = C * B_TWOPLY * tp.top_k_candidates
    nd_shapes = {(a[0].shape[0], a[7], a[8]) for a in nd_seen}
    fv_shapes = {tuple(b.shape[:-1]) for b, _ in fv_seen}
    want_nd = {(rows, tp.reply_a_max, tp.reply_a_max)} if want["nd_tail"] else set()
    want_fv = {(C, B_TWOPLY, tp.top_k_candidates, tp.reply_a_max)}
    if (len(nd_seen), len(fv_seen)) != (want["nd_tail"], want["fused_value"]) or (
            nd_shapes, fv_shapes) != (want_nd, want_fv):
        raise AssertionError(f"{tag}: kernel calls {len(nd_seen)} x {nd_shapes}, "
                             f"{len(fv_seen)} x {fv_shapes}")
    row = dict(nd_tail_calls=len(nd_seen), nd_tail_shape=sorted(nd_shapes),
               fused_value_calls=len(fv_seen), fused_value_shape=sorted(fv_shapes))
    if nd_seen:
        nd_err, after_all, kept, n_rows = nd_tail_vs_plain(P, nd_seen, dev)
        log(f"{tag} nd_tail at {sorted(nd_shapes)} x{len(nd_seen)}: max |diff| {nd_err} "
            f"over keep/n_pre/pct/kpair and {kept} kept afterstates of {n_rows} rows; after "
            f"equal at every slot: {after_all} {card}")
        if nd_err:
            raise AssertionError(f"{tag}: nd_tail differs from its plain version")
        per, step = nd_tail_timing(P, nd_seen[:1], dev)
        row.update(nd_err=float(nd_err), nd_tail_time={**per[0], "ms": step["ms"]})
        log(f"{tag} nd_tail one launch: {json.dumps(row['nd_tail_time'])} {card}")
    row["fv_err"] = phase_kernel_vs_plain(P, params, fv_seen, dev, gen, card,
                                          random_cases=False, tag=f"{tag} fused_value")
    row["fused_value_time"] = phase_kernel_timing(P, params, fv_seen[:1], dev, card,
                                                  f"{tag} fused_value", 10)
    return row


def phase_scan_and_value_first(P, dev, gen, card):
    """32-33: the 2-ply scan scorer and the value-first replies at B = 1024
    on one state's top-4 candidates: the scan at roll_chunk 1 bit-equal to
    the unrolled scorer (15 nd_tail + 21 fused_value launches each), at
    roll_chunk 3 within rtol 1e-5, atol 1e-6 of it (5 + 7 launches);
    value_first_m=16 (no nd_tail launch, 21 fused_value) equal to the
    reference-order scan where its inexact flag is clear (rtol 1e-6, atol
    1e-7); each scan scorer's kernels on its own inputs against their plain
    versions (``scorer_kernels_vs_plain``); then ms a step of the 2-ply
    rollout step with each scorer, launches gated."""
    R, VE, X, fv, nd = P["rollout"], P["vec_env"], P["X"], P["fv"], P["nd"]
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    variants = {
        "unrolled": (scan_config(P), {"fused_value": 21, "nd_tail": 15}),
        "scan_chunk1": (scan_config(P, unroll_rolls=False), {"fused_value": 21, "nd_tail": 15}),
        "scan_chunk3": (scan_config(P, roll_chunk=3), {"fused_value": 7, "nd_tail": 5}),
        "value_first16": (scan_config(P, value_first_m=VALUE_FIRST_M),
                          {"fused_value": 21, "nd_tail": 0}),
    }
    base = variants["unrolled"][0]
    state = VE.reset(B_TWOPLY, gen, device=dev)
    state = twoply_steps(P, params, state, base, dev, gen, 2)
    cand, opp = twoply_candidates(P, params, state, base)
    scores, held = {}, {}
    for name, (cfg, want) in variants.items():
        _sync(dev)
        fv.KERNEL.launches = nd.KERNEL.launches = 0
        with _capturing(P, X) as (nd_seen, fv_seen):
            scores[name] = X.weighted_opponent_response(params, cand, opp, cfg,
                                                        return_flags=True)
        _sync(dev)
        _gate({"fused_value": fv.KERNEL.launches, "nd_tail": nd.KERNEL.launches}, want,
              f"[32 scan] {name} scorer")
        if name != "unrolled":  # phases 9 and 14 hold the unrolled scorer's kernels
            held[name] = scorer_kernels_vs_plain(P, params, cfg, nd_seen, fv_seen, want,
                                                 dev, gen, card, f"[32 scan] {name}")
        del nd_seen, fv_seen
    ref = scores["unrolled"][0]
    if not torch.isfinite(ref).all():
        raise AssertionError("[32 scan] scores not finite")
    if not torch.equal(scores["scan_chunk1"][0], ref):
        raise AssertionError("[32 scan] the scan at chunk 1 differs from the unrolled scorer")
    err3 = float((scores["scan_chunk3"][0] - ref).abs().max())
    if not torch.allclose(scores["scan_chunk3"][0], ref, rtol=SCAN_RTOL, atol=SCAN_ATOL):
        raise AssertionError(f"[32 scan] chunk 3 off the unrolled scorer by {err3}")
    vf, flags = scores["value_first16"]
    clear = ~flags
    vf_err = float((vf - scores["scan_chunk1"][0])[clear].abs().max())
    if not torch.allclose(vf[clear], scores["scan_chunk1"][0][clear], rtol=VF_RTOL,
                          atol=VF_ATOL):
        raise AssertionError(f"[33 value first] scores off the reference order by {vf_err}")
    out = dict(candidates=list(cand.batch_shape), chunk1_bit_equal=True,
               chunk3_max_abs=err3, value_first_inexact=int(flags.sum()),
               value_first_max_abs_where_clear=vf_err, kernels=held, steps={})
    log(f"[32 scan] scorers on one state's candidates: {json.dumps(out)} {card}")
    noises = [R.draw_noise(B_TWOPLY, base, gen, dev) for _ in range(SCAN_STEPS)]
    for name, (cfg, want) in variants.items():
        twoply_steps(P, params, state, cfg, dev, gen, 1)  # warm-up
        _, traj, ms, launches = timed_steps(P, params, state, cfg, dev, gen, SCAN_STEPS, noises)
        _gate(launches, {"fused_value": SCAN_STEPS * (want["fused_value"] + 1),
                         "nd_tail": SCAN_STEPS * (want["nd_tail"] + ND_TIER_LAUNCHES)},
              f"[32 scan] {name} steps")
        out["steps"][name] = dict(batch=B_TWOPLY, ms_per_step=ms, launches=launches,
                                  env_steps_per_s=B_TWOPLY / (ms / 1e3))
        log(f"[{33 if name == 'value_first16' else 32} {'value first' if name == 'value_first16' else 'scan'}] "
            f"{name} 2-ply step: {json.dumps(out['steps'][name])} {card}")
        if not torch.isfinite(traj.value).all():
            raise AssertionError(f"[32 scan] {name} values not finite")
    return out


def phase_probe_xla_modes(P, card):
    """34: the probe's modes with no Pallas kernel behind them
    (``scripts.probe_take``, JAX script :99-197) in-process at the probe's
    shape: each exact (``ohonly`` n/a), with its ms."""
    probe = P["probe"]
    rows = {}
    for mode in probe.XLA_MODES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = probe.main([mode])
        lines = buf.getvalue().splitlines()
        want = "exact: n/a" if mode == "ohonly" else "exact: True"
        if rc != 0 or lines[:1] != [want]:
            raise AssertionError(f"[34 probe modes] {mode}: rc {rc}, {lines}")
        rows[mode] = dict(exact=lines[0].split(": ")[1],
                          ms=float(lines[1].split(": ")[1].split(" ms")[0]))
    log(f"[34 probe modes] N=4096, K=W=128: {json.dumps(rows)} {card}")
    return rows



# ---------------------------------------------------------------------------
# the rules-parity and quality tools
# ---------------------------------------------------------------------------

STRESS_BATCHES = 32  # phase 35: 32 x 128 = 4,096 positions of each config
GUARD_POSITIONS = 1024  # phase 36
GUARD_CPU_POSITIONS = 32  # and those held to the port's CPU path
GUARD_RTOL, GUARD_ATOL = 1e-5, 1e-6
GUARD_AGREE_MIN = 0.99
# the guard's score calls at Config() widths: the merged legal moves' tail,
# then the 15 non-double reply rolls
GUARD_ND_PER_SCORE = 16
PARITY_EPISODES = 400  # phase 37: two updates of 200 episodes
PARITY_CKPT_EVERY = 200
CURVE_GAMES = 256
H2H_GAMES = 256  # phase 38
H2H_ARGS = ["--agent-policy", "twoply", "--twoply-tuned", "--opponent", "twoply",
            "--opponent-scorer", "exact", "--checkpoint", str(CKPT), "--td-mode", "side0"]


def tool_nd_vs_plain(P, nd_seen, dev, what, card):
    """Every captured nd_tail call of a tool's path bit-equal to its plain
    version; logs the calls' [rows, K, a_max]. Returns calls, shapes, rows
    and kept slots."""
    if not nd_seen:
        raise AssertionError(f"{what}: no nd_tail call captured")
    worst, _, kept, rows = nd_tail_vs_plain(P, nd_seen, dev)
    shapes = sorted({(a[0].shape[0], a[7], a[8]) for a in nd_seen})
    row = dict(calls=len(nd_seen), shapes=shapes, rows=rows, kept=kept, max_abs_err=worst)
    log(f"{what}: nd_tail vs its plain version on the path's own calls: {json.dumps(row)} {card}")
    if worst != 0:
        raise AssertionError(f"{what}: nd_tail differs from its plain version")
    return row


def phase_stress(P, dev, card):
    """35: the rules stress (``scripts.stress_movegen2``) on the card,
    4,096 positions of each config: (a) the merged legal moves at
    ``MoveGenConfig(algo="canonical", dd_subbatch_div=0)``, doubles bias
    0.35, whose tail is nd_tail at [128, K = 576], one launch a batch; (b)
    ``legal_moves_split`` at ``MoveGenConfig.fast()`` with iid dice, two
    launches a batch (the tiers). 0 mismatches against the oracle; the overflow rows and
    positions/s of each; nd_tail on batch 0's inputs bit-equal to its plain
    version, one launch timed with its bound."""
    S, nd = P["stress"], P["nd"]
    cfg, bias, _ = S.configs()["a"]
    boards, players, dice = P["sampling"].sample_cases(S.SEED0, S.BATCH, doubles_bias=bias)
    data = torch.tensor([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
                        dtype=torch.int8, device=dev)
    seen = []
    real = nd.nd_tail_fused
    with _Swap(nd, "nd_tail_fused", lambda *a: seen.append(a) or real(*a)):
        S.engine_rows(cfg, False, data, torch.tensor(players, dtype=torch.int32, device=dev),
                      torch.tensor(dice, dtype=torch.int32, device=dev))
    if [(a[0].shape[0], a[7], a[8]) for a in seen] != [(S.BATCH, 576, 512)]:
        raise AssertionError(f"[35 stress] unexpected nd_tail calls "
                             f"{[(a[0].shape, a[7:]) for a in seen]}")
    out = {"nd_tail_time": nd_one_launch(P, seen[0], dev, "[35 stress] nd_tail at [128, K = 576]")}
    log(f"[35 stress] nd_tail at [128, K = 576], bit-equal to its plain version: "
        f"{json.dumps(out['nd_tail_time'])} {card}")
    for name in ("a", "b"):
        nd.KERNEL.launches = 0
        rep = S.run(name, STRESS_BATCHES, dev, log=log)
        _sync(dev)
        rep["launches"] = nd.KERNEL.launches
        log(f"[35 stress] config {name}: {json.dumps(rep)} {card}")
        if rep["mismatches"] or rep["positions"] != STRESS_BATCHES * S.BATCH:
            raise AssertionError(f"[35 stress] config {name}: {rep['mismatches']} mismatches")
        _gate(rep["launches"], STRESS_BATCHES * (1 if name == "a" else ND_TIER_LAUNCHES),
              f"[35 stress] {name} nd_tail")
        out[name] = rep
    return out


def phase_guard(P, dev, card):
    """36: the tuned-vs-exact decision guard (``scripts.twoply_decision_guard``)
    on 1,024 positions of 1-ply greedy self-play (B = 512, 96 steps, the
    checkpoint's weights): both scorers' top-K slots and scores on the
    card, 16 nd_tail launches a score call (its legal moves' tail at K = 576
    and 15 reply rolls) and one a collect step; the first 32 positions
    scored again on the card in a call of their own, and on the port's CPU
    path in one of the same size: slots equal, scores within rtol 1e-5,
    atol 1e-6 (TF32 off), and the 1,024-position call's slots and scores
    for them the same; agreement >= 0.99; every nd_tail call of the collect
    ([512, K = 576]) and of the scoring bit-equal to its plain version."""
    G, nd = P["guard"], P["nd"]
    tuned, exact = G.configs()
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    nd.KERNEL.launches = 0
    t0 = time.perf_counter()
    with _capturing(P, P["X"]) as (collect_seen, _):
        pos, pool = G.collect(params, exact, GUARD_POSITIONS, dev)
        _sync(dev)
    collect_s = time.perf_counter() - t0
    _gate(nd.KERNEL.launches, G.COLLECT_STEPS, "[36 guard] collect nd_tail")
    launches = nd.KERNEL.launches
    if len(pos["player"]) != GUARD_POSITIONS:
        raise AssertionError(f"[36 guard] {len(pos['player'])} positions of {GUARD_POSITIONS}")
    card_out, seconds = {}, {}
    with _capturing(P, P["X"]) as (nd_seen, _):
        for name, cfg in (("tuned", tuned), ("exact", exact)):
            nd.KERNEL.launches = 0
            t0 = time.perf_counter()
            card_out[name] = G.score(params, pos["packed"], pos["player"], pos["dice"], cfg, dev)
            _sync(dev)
            seconds[name] = time.perf_counter() - t0
            _gate(nd.KERNEL.launches, GUARD_ND_PER_SCORE, f"[36 guard] {name} nd_tail")
            launches += nd.KERNEL.launches
    nd_collect = tool_nd_vs_plain(P, collect_seen, dev, "[36 guard] collect", card)
    del collect_seen
    nd_score = tool_nd_vs_plain(P, nd_seen, dev, "[36 guard] scoring", card)
    del nd_seen
    cpu_params = {k: v.cpu() for k, v in params.items()}
    n = GUARD_CPU_POSITIONS
    few = (pos["packed"][:n], pos["player"][:n], pos["dice"][:n])

    def same(a, b):
        """(slots equal, the same live slots, scores within tolerance, max |d|)."""
        live = b[1] > -1e8
        err = float(abs(a[1][live] - b[1][live]).max())
        ok = ((a[0] == b[0]).all() and (live == (a[1] > -1e8)).all()
              and torch.allclose(torch.from_numpy(a[1][live]), torch.from_numpy(b[1][live]),
                                 rtol=GUARD_RTOL, atol=GUARD_ATOL))
        return bool(ok), err

    errs = {}
    for name, cfg in (("tuned", tuned), ("exact", exact)):
        # one call of n positions on each side: the same program, so any
        # difference is the device's; then the 1,024-position call's rows
        on_cpu = G.score(cpu_params, *few, cfg, "cpu")
        on_card = G.score(params, *few, cfg, dev)
        ok_dev, errs[name] = same(on_card, on_cpu)
        ok_call, errs[name + "_in_1024_call"] = same(
            tuple(x[:n] for x in card_out[name]), on_card)
        if not (ok_dev and ok_call):
            raise AssertionError(f"[36 guard] {name}: card {n}-position call vs CPU: {ok_dev}, "
                                 f"1,024-position call vs card {n}-position call: {ok_call} "
                                 f"(max |d| {errs})")
    rep = G.report(*card_out["tuned"], *card_out["exact"])
    row = dict(report=rep, pool=pool, collect_s=collect_s, score_s=seconds,
               card_vs_cpu_max_abs=errs, nd_tail_collect=nd_collect, nd_tail_score=nd_score,
               launches=launches, card=card)
    log(f"[36 guard] {json.dumps(row)}")
    if rep["agreement"] < GUARD_AGREE_MIN:
        raise AssertionError(f"[36 guard] agreement {rep['agreement']} < {GUARD_AGREE_MIN}")
    return row


def phase_parity_and_curve(P, dev, card):
    """37: two updates of the parity trainer (``scripts.run_parity_trainer``,
    B = 200 sync games of at most 300 steps, 200 Adam steps an update;
    nd_tail once a rollout step) with checkpoints at episodes 0, 200 and
    400, the last equal to the trained params bitwise and ``train.jsonl``
    with JAX's keys, and the nd_tail calls of one eager rollout step at
    B = 200 (after three) bit-equal to its plain version; then the curve (``scripts.eval_curve``) over them at
    256 games: exactly 2 graphs captured, one nd_tail launch a match step,
    and each checkpoint's winners equal to a separate ``play_match`` call
    on freshly loaded params with the same seeds."""
    R, E, A, nd, V = P["parity"], P["curve"], P["arena"], P["nd"], P["value_net"]
    out = {}
    with tempfile.TemporaryDirectory() as run:
        P["graphs"].clear_graphs()
        nd.KERNEL.launches = 0
        t0 = time.perf_counter()
        cfg = R.parity_config(0)
        state = R.run(cfg, PARITY_EPISODES, run, PARITY_CKPT_EVERY, dev, log=log)
        _sync(dev)
        out["train_s"] = time.perf_counter() - t0
        updates = PARITY_EPISODES // cfg.train.batch_games
        _gate(nd.KERNEL.launches, updates * cfg.env.max_timesteps, "[37 parity trainer] nd_tail")
        out["train_launches"] = nd.KERNEL.launches
        names = sorted(f for f in os.listdir(run) if f.endswith(".pth"))
        want = [f"ep{e:08d}.pth" for e in range(0, PARITY_EPISODES + 1, PARITY_CKPT_EVERY)]
        lines = [json.loads(x) for x in open(os.path.join(run, "train.jsonl"))]
        last = V.load_checkpoint(os.path.join(run, want[-1]), device=dev)
        if names != want or len(lines) != updates or any(
                set(x) != {"episodes", "version", "temperature", "loss", "eps_per_sec"}
                or not math.isfinite(x["loss"]) for x in lines) or not all(
                torch.equal(last[k], state.params[k]) for k in last):
            raise AssertionError(f"[37 parity trainer] {names} {lines}")
        out["train_jsonl"] = lines
        log(f"[37 parity trainer] {updates} updates in {out['train_s']:.1f}s, checkpoints "
            f"{names}, {out['train_launches']} nd_tail launches: {json.dumps(lines)} {card}")
        gen = torch.Generator(device=dev).manual_seed(0)
        st = P["vec_env"].reset(cfg.train.batch_games, gen, device=dev)
        temp = P["td"].temperature(state.version, cfg)
        for i in range(4):
            with _capturing(P, P["X"]) as (nd_seen, _):
                st, _ = P["rollout"].rollout_step(state.params, st, temp, cfg, False,
                                                  gen=gen, device=dev)
        out["nd_tail_step"] = tool_nd_vs_plain(P, nd_seen, dev, "[37 parity trainer] "
                                               "rollout step 4", card)
        del nd_seen

        P["graphs"].clear_graphs()
        nd.KERNEL.launches = 0
        curves, info = E.sweep([run], CURVE_GAMES, 0, EVAL_STEPS, dev, log=log)
        _sync(dev)
        out["curve_launches"] = nd.KERNEL.launches
        _gate(out["curve_launches"], len(want) * 2 * EVAL_STEPS, "[37 curve] nd_tail")
        if info["captures"] != 2:
            raise AssertionError(f"[37 curve] {info['captures']} graphs captured, want 2")
        cfg = P["Config"]()
        greedy, rand = A.greedy_policy(cfg), A.random_policy(cfg)
        for i, (eps, path, _) in enumerate(E.checkpoints(run)):
            fresh = V.load_checkpoint(path, device=dev)
            seed = E.SEED_STRIDE * (i + 1)
            for side, (pa, pb) in enumerate(((greedy, rand), (rand, greedy))):
                res = A.play_match(fresh, fresh, pa, pb,
                                   torch.Generator(device=dev).manual_seed(seed + side), cfg,
                                   CURVE_GAMES // 2, EVAL_STEPS, device=dev)
                if not torch.equal(res.winner.cpu(), info["winners"][run][i][side]):
                    raise AssertionError(f"[37 curve] ep{eps} side {side}: winners differ "
                                         "from a separate play_match")
        P["graphs"].clear_graphs()
        out.update(curve=curves[run], captures=info["captures"], curve_s=info["seconds"])
        log(f"[37 curve] {len(want)} checkpoints x {CURVE_GAMES} games in "
            f"{info['seconds']:.1f}s, {info['captures']} graphs captured, winners equal to "
            f"separate play_match calls: {json.dumps(curves[run])} {card}")
    return out


def phase_head_to_head(P, dev, card):
    """38: ``apps.evaluate`` tuned 2-ply agent against the exact 2-ply
    opponent (the checkpoint, td_mode side0) at 256 games, 400 steps:
    JAX's summary keys, finished > 0, nd_tail once a match step plus 15
    times a step for each 2-ply side; the win rate and wall seconds. Then
    the nd_tail calls of one eager match step of the same two policies at
    256 games (after two) bit-equal to its plain version."""
    nd, A, C = P["nd"], P["arena"], P["cfg"]
    P["graphs"].clear_graphs()
    argv = H2H_ARGS + ["--games", str(H2H_GAMES)]
    buf = io.StringIO()
    _sync(dev)
    nd.KERNEL.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = P["evaluate"].main(argv)
    _sync(dev)
    wall = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    row = dict(argv=argv, rc=rc, wall_s=wall, launches=nd.KERNEL.launches, summary=summary,
               card=card)
    log(f"[38 head-to-head] tuned vs exact: win rate {summary.get('win_rate_a')}: "
        f"{json.dumps(row)}")
    _gate(row["launches"], EVAL_STEPS * (1 + 2 * 15), "[38 head-to-head] nd_tail")
    if rc != 0 or set(summary) != SUMMARY_KEYS or summary["games"] != H2H_GAMES \
            or summary["finished"] <= 0:
        raise AssertionError(f"[38 head-to-head] {rc} {summary}")
    P["graphs"].clear_graphs()
    # the CLI's two configs and policies (apps.evaluate's make_cfg)
    cfg_a, cfg_b = (C.Config(twoply=tw, train=C.TrainConfig(td_mode="side0"))
                    for tw in (C.TwoPlyConfig.tuned(), C.TwoPlyConfig(enabled=True)))
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    pa, pb = A.twoply_greedy_policy(cfg_a), A.twoply_greedy_policy(cfg_b)
    gen = torch.Generator(device=dev).manual_seed(0)
    m = A._Match(P["vec_env"].reset(H2H_GAMES, gen, device=dev),
                 torch.full((H2H_GAMES,), -1, dtype=torch.int32, device=dev))
    with torch.no_grad():
        for i in range(3):
            with _capturing(P, P["X"]) as (nd_seen, _):
                m = A.match_step(params, params, pa, pb, cfg_a, m,
                                 A.draw_match_noise(H2H_GAMES, cfg_a, gen, dev))
    row["nd_tail_step"] = tool_nd_vs_plain(P, nd_seen, dev, "[38 head-to-head] match step 3",
                                           card)
    return row


# ---------------------------------------------------------------------------
# the measurement tools (phases 39-42)
# ---------------------------------------------------------------------------

# phase 39: the headline bench's steps (scripts.bench.run at its defaults:
# max(8 // 4, 2) chunks of warm-up and 50 // 4 timed, 4 steps a chunk), the
# 1 + 4 eager steps of its chunk count, and --eager's run of the same steps
BENCH_STEPS = (max(8 // 4, 2) + 50 // 4) * 4
BENCH_1PLY_STEPS = BENCH_STEPS + 1 + 4 + BENCH_STEPS
BENCH_TWOPLY_STEPS = 2 + 12  # bench_twoply's 2 warm-up and 12 timed steps
BENCH_KEYS = ("value", "ms_per_step", "mfu", "achieved_bw_frac")
CEILING = 1.05  # a fraction of a published peak above this means a wrong count
B_COUNT = 256  # phase 40: the 1-ply step's count, card against CPU
# phase 41: the JAX scope names each step passes through that a stage tag
# keeps (tests/test_torch_bench_tools.py holds the full sets to JAX's)
# (on the card the doubles enumeration is one launch of the doubles kernel in
# scope dd_L1, where the plain chain passes through dd_L2-dd_L4 with slotv,
# sel and take inside each; the kernel launches inside its dispatcher op, so
# the profiler links it to dd_L1)
STAGES_1PLY = {"nd_front", "nd_tail_t1", "nd_tail_t2", "dd_L1", "act_t1", "act_t2",
               "env_step"}
STAGES_2PLY = ({"nd_front", "nd_tail", "nd_tail_t1", "nd_tail_t2", "dd_L1", "mg_merge",
                "env_step"}
               | {f"dd{d}" for d in range(1, 7)}
               | {f"nd{h}{lo}" for h in range(2, 7) for lo in range(1, h)})
ATTR_TOP = 15
# phase 42: the sweep at a reduced step count (tier0 alone: JAX's split-plane
# step refuses it too), then bench_spmd at n = 1
SWEEP_VARIANTS = ("prod", "prod_gram", "tiered", "twoply_tuned")
SWEEP_ARGS = ["--steps", "8", "--twoply-steps", "4"]
SPMD_ARGS = ["--steps", "4"]


def _tool_lines(main, argv):
    """A tool's ``main(argv)`` in this process: (exit code, its JSON lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def _positive(row, keys, what):
    for k in keys:
        v = row.get(k)
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"{what}: {k} is {v!r}")


def phase_bench(P, dev, card, graph_ms):
    """39: the headline bench (``scripts.bench.main --eager``: the 1-ply
    step graphed at chunk 4 and eager, B = 4096) and the 2-ply bench
    (``scripts.bench_twoply.main``, tuned and plain, B = 1024, graphed at
    chunk 1): one JSON line each with its keys finite and positive, and
    fused_value and nd_tail launched 2 a step each of the 1-ply run
    (graphed, counted and eager) and 22 and 17 a step of the tuned 2-ply
    run. The graphed
    1-ply ms/step beside phase 22's, no gate on time."""
    fv, nd = P["fv"].KERNEL, P["nd"].KERNEL
    out = {}
    for name, main, argv, want in (
        ("1ply", P["bench"].main, ["--eager"],
         {"fused_value": 2 * BENCH_1PLY_STEPS,
          "nd_tail": ND_LAUNCHES_PER_STEP_1PLY * BENCH_1PLY_STEPS}),
        ("2ply_tuned", P["bench_twoply"].main, [],
         {"fused_value": FV_LAUNCHES_PER_STEP_2PLY * BENCH_TWOPLY_STEPS,
          "nd_tail": ND_LAUNCHES_PER_STEP_2PLY * BENCH_TWOPLY_STEPS}),
        ("2ply_plain", P["bench_twoply"].main, ["1024", "12", "plain"], None),
    ):
        P["graphs"].clear_graphs()
        _sync(dev)
        fv.launches = nd.launches = 0
        rc, lines = _tool_lines(main, argv)
        _sync(dev)
        launches = {"fused_value": fv.launches, "nd_tail": nd.launches}
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"[39 bench] {name}: exit {rc}, {len(lines)} JSON lines")
        row = lines[0]
        _positive(row, BENCH_KEYS if name == "1ply" else ("value", "ms_per_step"),
                  f"[39 bench] {name}")
        if want is not None and launches != want:
            raise AssertionError(f"[39 bench] {name}: launches {launches}, want {want}")
        out[name] = dict(row, launches=launches)
        log(f"[39 bench] {name}: {json.dumps(out[name])}")
    log(f"[39 bench] 1-ply graphed {out['1ply']['ms_per_step']:.3f} ms/step "
        f"(phase 22 at chunk 4: {graph_ms:.3f}), eager {out['1ply']['eager_ms_per_step']:.3f}; "
        f"2-ply tuned {out['2ply_tuned']['ms_per_step']:.3f}, plain "
        f"{out['2ply_plain']['ms_per_step']:.3f} ms/step {card}")
    P["graphs"].clear_graphs()
    return out


def phase_roofline(P, dev, card):
    """40: ``scripts.roofline.main all``: the launch floor, the measured
    bf16 and HBM peaks, each at most 1.05 of the published one, and each
    step's achieved fractions at most 1.05 of the published peaks; then one
    1-ply production step's count (``utils.cost``) on the card equal, op by
    op and tag by tag, to the CPU's from the same state and params."""
    B, C = P["bench"], P["cost"]
    fv, nd = P["fv"].KERNEL, P["nd"].KERNEL
    P["graphs"].clear_graphs()
    path = Path(tempfile.mkdtemp(prefix="roofline_")) / "roofline.json"
    fv.launches = nd.launches = 0
    rc, _ = _tool_lines(P["roofline"].main, ["all", "--out", str(path)])
    launches = {"fused_value": fv.launches, "nd_tail": nd.launches}
    res = json.loads(path.read_text())
    if rc != 0:
        raise AssertionError(f"[40 roofline] exit {rc}")
    log(f"[40 roofline] peaks: {json.dumps({k: v for k, v in res.items() if k not in ('oneply', 'twoply')})}")
    peaks = {"measured_peak_tflops_bf16": C.BF16_FLOP_PER_S / 1e12,
             "measured_peak_hbm_gbs": C.HBM_BYTES_PER_S / 1e9}
    for k, published in peaks.items():
        if not 0 < res[k] <= CEILING * published:
            raise AssertionError(f"[40 roofline] {k} {res[k]} against published {published}")
    for w in ("oneply", "twoply"):
        r = res[w]
        log(f"[40 roofline] {w}: {json.dumps(r)}")
        for k in ("mfu_vs_datasheet", "bw_frac_vs_datasheet"):
            if not 0 < r[k] <= CEILING:
                raise AssertionError(f"[40 roofline] {w} {k} = {r[k]}: the count is wrong")
        log(f"[40 roofline] {w}: {r['ms_per_step']:.3f} ms/step, "
            f"{r['hbm_bytes_per_disp'] / 1e9:.3f} GB and {r['flops_per_disp'] / 1e9:.3f} GFLOP "
            f"a dispatch of {r['steps_per_disp']}, bf16 {r['mfu_vs_datasheet']:.5f} "
            f"({r['mfu_vs_measured']:.5f} of measured), HBM {r['bw_frac_vs_datasheet']:.4f} "
            f"({r['bw_frac_vs_measured']:.4f} of measured) {card}")
    cfg = B.production_config()
    params, state, temp, _ = B.setup(cfg, B_COUNT, dev)
    on_card = B.chunk_cost(params, state, temp, cfg, 1, dev)
    cpu = torch.device("cpu")
    on_cpu = B.chunk_cost({k: v.cpu() for k, v in params.items()}, _to_cpu(state), temp.cpu(),
                          cfg, 1, cpu)
    if on_card.by_tag != on_cpu.by_tag:
        diff = {t for t in set(on_card.by_tag) | set(on_cpu.by_tag)
                if on_card.by_tag.get(t) != on_cpu.by_tag.get(t)}
        raise AssertionError(f"[40 roofline] the card's count differs from the CPU's at {diff}")
    log(f"[40 roofline] one 1-ply step at B={B_COUNT}: the card's count equals the CPU's "
        f"({on_card.flops:.6g} flops, {on_card.elementwise_ops:.6g} elementwise ops, "
        f"{on_card.bytes:.6g} bytes, {len(on_card.by_tag)} tags)")
    P["graphs"].clear_graphs()
    return dict(res, launches=launches)


def phase_trace_attr(P, dev, card):
    """41: ``scripts.trace_attr.attribute`` of one eager step of ``prod`` at
    B = 4096 and of ``twoply_tuned`` at B = 1024: every JAX stage the step
    passes through owns device time in a tag; the top rows, the unscoped
    share and the coverage against the step's device time queued behind a
    spin kernel. The graphed step replays the same kernels."""
    TA, prof = P["trace_attr"], P["profiling"]
    fv, nd = P["fv"].KERNEL, P["nd"].KERNEL
    out = {}
    for name, batch, want in (("prod", B_PROD, STAGES_1PLY),
                              ("twoply_tuned", B_TWOPLY, STAGES_2PLY)):
        fv.launches = nd.launches = 0
        a = TA.attribute(name, batch, dev)
        launches = {"fused_value": fv.launches, "nd_tail": nd.launches}
        for line in TA.report(name, batch, ATTR_TOP, a):
            log(f"[41 trace_attr] {line}")
        got = {p for t in a["stages"] for p in t.split("/") if prof.STAGE_RE.fullmatch(p)}
        if want - got:
            raise AssertionError(f"[41 trace_attr] {name}: no device time under {want - got}")
        unscoped = TA.unscoped_ms(a["stages"])
        row = dict(batch=batch, attributed_ms=a["attributed_ms"], traced_ms=a["traced_ms"],
                   device_ms=a["device_ms"], unscoped_ms=unscoped,
                   unscoped_share=unscoped / a["attributed_ms"],
                   coverage=a["attributed_ms"] / a["device_ms"], total_gb=a["total_bytes"] / 1e9,
                   outer=TA.outer_stages(a["stages"]),
                   top={t: v for t, v in list(a["stages"].items())[:ATTR_TOP]},
                   launches=launches)
        log(f"[41 trace_attr] {name}: {json.dumps(row)} {card}")
        out[name] = row
    return out


# phase 43: the doubles kernel on the inputs of the benchmark cells' steps
DD_STEPS = (("1ply", B_PROD, DD_LAUNCHES_PER_STEP_1PLY),  # (path, batch, calls a step)
            ("2ply", B_TWOPLY, DD_LAUNCHES_PER_STEP_2PLY))
DD_WARM_STEPS = 6  # off the opening first
DD_ITERS = 20


def capture_dd_calls(P, params, cfg, batch, dev, gen):
    """The (board, player, die, movegen config) of every ``enumerate_doubles``
    call of one eager production step at ``batch``, ``DD_WARM_STEPS`` steps
    off the opening."""
    M, R = P["movegen2"], P["rollout"]
    state = P["vec_env"].reset(batch, gen, device=dev)
    state, _ = R.rollout_loop(params, state, 1.0, cfg, DD_WARM_STEPS, True, gen=gen, device=dev)
    seen, real = [], M.enumerate_doubles

    def keep(board, player, die, mcfg, s1=None):
        n = board.data.shape[0]
        rows = lambda x: torch.broadcast_to(torch.as_tensor(x, device=dev), (n,)).clone()
        seen.append((P["board"].Board(board.data.clone()), rows(player), rows(die), mcfg))
        return real(board, player, die, mcfg, s1)

    M.enumerate_doubles = keep
    try:
        R.rollout_step(params, state, 1.0, cfg, True, gen=gen, device=dev)
    finally:
        M.enumerate_doubles = real
    _sync(dev)
    return seen


def phase_dd_expand(P, params, dev, gen, card):
    """43: the doubles kernel (``ops.dd_expand``) on the inputs of one 1-ply
    production step (B = 4096: one call, its 1,024-game doubles sub-batch at
    fast() widths) and one 2-ply step (B = 1024: its own 256 games, then six
    reply dice on 4,096 positions at the tuned widths): each call's outputs
    equal the plain chain's byte for byte (the largest difference and the
    differing elements over the four tensors, both 0); each call timed with
    CUDA events (plain, kernel, kernel, plain) beside its bound and launch plan; a
    step's launches queued behind a spin kernel."""
    M, D = P["movegen2"], P["dd"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, batch, calls_per_step in DD_STEPS:
        cfg = production_config(P) if name == "1ply" else twoply_config(P)
        calls = capture_dd_calls(P, params, cfg, batch, dev, gen)
        if len(calls) != calls_per_step:
            raise AssertionError(f"[43 dd_expand] {name}: {len(calls)} calls a step, "
                                 f"want {calls_per_step}")
        per, kernel_calls = [], []
        for board, player, die, mcfg in calls:
            kern = functools.partial(M.enumerate_doubles, board, player, die, mcfg)
            plain = functools.partial(M.enumerate_doubles_plain, board, player, die, mcfg)
            got, want = kern(), plain()
            _sync(dev)
            diff = {}
            for f in ("boards", "valid", "count", "overflow"):
                a, b = getattr(got, f), getattr(want, f)
                a, b = getattr(a, "data", a).int(), getattr(b, "data", b).int()
                if a.shape != b.shape:
                    raise AssertionError(f"[43 dd_expand] {name}: {f} {tuple(a.shape)} against "
                                         f"the plain chain's {tuple(b.shape)}")
                d = (a - b).abs()
                diff[f] = (int(d.max()) if d.numel() else 0, int((d != 0).sum()))
            max_abs = max(m for m, _ in diff.values())
            differing = sum(c for _, c in diff.values())
            if differing:
                raise AssertionError(f"[43 dd_expand] {name}: differs from the plain chain at "
                                     f"widths {D.widths_of(mcfg)}: {diff}")
            p1, k1, k2, p2 = (_time_ms(f, dev, DD_ITERS) for f in (plain, kern, kern, plain))
            n, widths = board.data.shape[0], D.widths_of(mcfg)
            row = dict(widths=list(widths), plan=D.plan(n, widths, sms),
                       max_abs_err=max_abs, differing_elements=differing,
                       moves_per_game=float(got.count.float().mean()),
                       overflow_games=int(got.overflow.sum()), events_ms=(k1 + k2) / 2,
                       plain_ms=(p1 + p2) / 2, runs_ms=[p1, k1, k2, p2], **D.bound(n, widths))
            per.append(row)
            kernel_calls.append(kern)
            log(f"[43 dd_expand] {name}: {json.dumps(row)} {card}")
        step = dict(calls_per_step=len(per), ms=_queued_ms_per_round(kernel_calls, dev),
                    max_abs_err=max(r["max_abs_err"] for r in per),
                    events_ms=sum(r["events_ms"] for r in per),
                    plain_ms=sum(r["plain_ms"] for r in per),
                    bound_ms=sum(r["bound_ms"] for r in per))
        step["roofline"] = step["bound_ms"] / step["ms"]
        log(f"[43 dd_expand] {name} one step: {json.dumps(step)} {card}")
        out[name] = dict(step, calls=per)
    return out


def wildbg(P, cfg):
    """``cfg`` with wildbg's deep net (``ModelConfig.wildbg``) in place of
    Tesauro's, the other model settings kept."""
    deep = P["cfg"].ModelConfig.wildbg()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, hidden_sizes=deep.hidden_sizes, activation=deep.activation))


def phase_mlp_value(P, dev, gen, card):
    """44: D2 (``ops.mlp_value``) with seeded wildbg weights on the calls of
    one eager 1-ply production step (B = 4096) and one 2-ply step (B = 1024),
    each a few steps off the opening: the launches a step gated (2 and 22),
    each call against ``mlp_value_plain`` (|dv| within ``SPREAD_TOL`` of the
    spread of the step's plain values) and its valid
    rows added to the rows-needed counter, timed with CUDA events (plain,
    kernel, kernel, plain) beside its bound and beside the kernel valuing
    every padded slot (no mask, the design not taken); a step's launches
    queued behind a spin, masked and not."""
    M, R = P["mlp"], P["rollout"]
    params = P["value_net"].init_params(P["cfg"].ModelConfig.wildbg(),
                                        torch.Generator().manual_seed(2026), "cpu")
    params = {k: v.to(dev) for k, v in params.items()}
    out = {}
    for name, batch, per_step in MLP_STEPS:
        cfg = wildbg(P, production_config(P) if name == "1ply" else twoply_config(P))
        state = P["vec_env"].reset(batch, gen, device=dev)
        state, _ = R.rollout_loop(params, state, 1.0, cfg, DD_WARM_STEPS, True, gen=gen,
                                  device=dev)
        seen, real = [], M.mlp_value

        def keep(boards, flag, p, valid=None):
            seen.append((boards.clone(), torch.as_tensor(flag, device=dev).clone(),
                         None if valid is None else valid.clone()))
            return real(boards, flag, p, valid)

        launches = M.KERNEL.launches
        M.mlp_value = keep
        try:
            R.rollout_step(params, state, 1.0, cfg, True, gen=gen, device=dev)
        finally:
            M.mlp_value = real
        _sync(dev)
        launches = M.KERNEL.launches - launches
        if launches != per_step or len(seen) != per_step:
            raise AssertionError(f"[44 mlp_value] {name}: {launches} launches, {len(seen)} "
                                 f"calls a step, want {per_step}")
        per, kernel_calls, padded_calls, checked = [], [], [], []
        for boards, flag, valid in seen:
            c0 = M.counters(dev).clone()
            got = M.mlp_value(boards, flag, params, valid)
            want = M.mlp_value_plain(boards, flag, params, valid)
            _sync(dev)
            checked.append((got, want, int((M.counters(dev) - c0)[0])))
        wanted = torch.cat([w[v] if v is not None else w.reshape(-1)
                            for (_, w, _), (_, _, v) in zip(checked, seen)])
        tol = M.SPREAD_TOL * float(wanted.max() - wanted.min())
        for (boards, flag, valid), (got, want, need) in zip(seen, checked):
            kern = functools.partial(M.mlp_value, boards, flag, params, valid)
            plain = functools.partial(M.mlp_value_plain, boards, flag, params, valid)
            rows = int(valid.sum()) if valid is not None else boards.numel() // 52
            err = float((got - want).abs().max()) if got.numel() else 0.0
            if err > tol or need != rows:
                raise AssertionError(f"[44 mlp_value] {name} {tuple(boards.shape)}: |dv| {err} "
                                     f"(tolerance {tol}), rows needed {need} of {rows}")
            p1, k1, k2, p2 = (_time_ms(f, dev, MLP_ITERS) for f in (plain, kern, kern, plain))
            # the other design: every padded slot valued (no mask)
            padded = functools.partial(M.mlp_value, boards, flag, params)
            row = dict(shape=list(boards.shape[:-1]), rows=rows, max_abs_err=err, tolerance=tol,
                       events_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, runs_ms=[p1, k1, k2, p2],
                       every_row_ms=_time_ms(padded, dev, MLP_ITERS),
                       **{k: v for k, v in M.bound(rows).items() if k != "rows"})
            per.append(row)
            kernel_calls.append(kern)
            padded_calls.append(padded)
            log(f"[44 mlp_value] {name}: {json.dumps(row)} {card}")
        b = M.bound(sum(r["rows"] for r in per), len(per))
        step = dict(calls_per_step=len(per), launches=launches,
                    ms=_queued_ms_per_round(kernel_calls, dev),
                    every_row_ms=_queued_ms_per_round(padded_calls, dev),
                    max_abs_err=max(r["max_abs_err"] for r in per),
                    events_ms=sum(r["events_ms"] for r in per),
                    plain_ms=sum(r["plain_ms"] for r in per), rows=b["rows"],
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        step["roofline"] = step["bound_ms"] / step["ms"]
        log(f"[44 mlp_value] {name} one step: {json.dumps(step)} {card}")
        out[name] = dict(step, calls=per)
    return out


def phase_sweep_and_spmd(P, dev, card):
    """42: ``scripts.bench_r2_sweep.main`` over prod, prod_gram, tiered and
    twoply_tuned at a reduced step count (exit 0, one JSON line each);
    tier0 alone exits 1 with one line naming it (JAX's split-plane step
    asserts a tiered tail too); ``scripts.bench_spmd.main`` at n = 1 on a
    one-rank NCCL group (exit 0, one JSON line)."""
    fv, nd = P["fv"].KERNEL, P["nd"].KERNEL
    P["graphs"].clear_graphs()
    fv.launches = nd.launches = 0
    rc, lines = _tool_lines(P["sweep"].main,
                            ["--variants", ",".join(SWEEP_VARIANTS)] + SWEEP_ARGS)
    launches = {"fused_value": fv.launches, "nd_tail": nd.launches}
    if rc != 0 or [x.get("variant") for x in lines] != list(SWEEP_VARIANTS):
        raise AssertionError(f"[42 sweep] exit {rc}: {lines}")
    for x in lines:
        _positive(x, ("env_steps_per_s",), f"[42 sweep] {x['variant']}")
        log(f"[42 sweep] {json.dumps(x)}")
    rc0, refused = _tool_lines(P["sweep"].main, ["--variants", "tier0", "--steps", "2"])
    if rc0 != 1 or len(refused) != 1 or refused[0].get("variant") != "tier0" \
            or "error" not in refused[0]:
        raise AssertionError(f"[42 sweep] tier0: exit {rc0}, {refused}")
    log(f"[42 sweep] tier0 refused, exit 1: {refused[0]['error']}")
    P["graphs"].clear_graphs()
    rc, spmd = _tool_lines(P["spmd"].main, SPMD_ARGS)
    if rc != 0 or len(spmd) != 1 or spmd[0].get("devices") != 1:
        raise AssertionError(f"[42 bench_spmd] exit {rc}: {spmd}")
    _positive(spmd[0], ("env_steps_per_s",), "[42 bench_spmd]")
    log(f"[42 bench_spmd] n = 1 (a one-rank NCCL group; the scaling column needs more "
        f"cards): {json.dumps(spmd[0])}")
    return dict(sweep=lines, tier0=refused[0], spmd=spmd[0], launches=launches)


def main() -> int:
    # the port's package first: importing it touches no device
    if not (ROOT / PORT_PACKAGE / "__init__.py").is_file():
        print(f"chip_smoke: the port's package {PORT_PACKAGE} is not in {ROOT}; run the "
              "script from the root of a checkout of the repository", file=sys.stderr)
        return 1
    P = _port()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 2
    # the plain version's matmuls must run in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    name, count, smi = phase_device()
    card = f"[{smi}]"
    phase_build(P)
    stamp_check = phase_stamp(P, dev, card)

    cfg = production_config(P)
    params = P["value_net"].load_checkpoint(str(CKPT), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = P["vec_env"].reset(B_PROD, gen, device=dev)
    state, real_inputs, nd1_seen = capture_candidates(P, params, state, cfg, dev, gen)
    if [tuple(b.shape[:-1]) for b, _ in real_inputs] != [(B_PROD, 96), (B_PROD // 16, 448)]:
        raise AssertionError(f"unexpected main-path shapes {[b.shape for b, _ in real_inputs]}")
    tiers = [(B_PROD, 96, 448), (B_PROD // cfg.movegen.nd_wide_div, 288, 448)]
    if [(a[0].shape[0], a[7], a[8]) for a in nd1_seen] != tiers:
        raise AssertionError(f"unexpected main-path nd_tail calls "
                             f"{[(a[0].shape, a[7:]) for a in nd1_seen]}")
    max_err = phase_kernel_vs_plain(P, params, real_inputs, dev, gen, card)
    nd1_err = phase_tiers_vs_plain(P, nd1_seen, dev, card)

    state, stats = phase_main_path(P, params, state, cfg, dev, gen, card)
    phase_same_step(P, params, state, cfg, dev, gen, card)
    phase_card_vs_cpu(P, params, cfg, dev, gen, card)
    phase_time_breakdown(P, params, state, cfg, dev, gen, stats["ms_per_step"], card)
    fv1_step = phase_kernel_timing(P, params, real_inputs, dev, card)
    nd1_per, nd1_step = nd_tail_timing(P, nd1_seen, dev)
    log(f"[8 kernel time] nd_tail per tier launch: "
        f"{json.dumps([{k: r[k] for k in ('rows', 'K', 'present_per_row', 'bound_ms', 'events_ms', 'plain_ms')} for r in nd1_per])}; "
        f"one step's two launches: {json.dumps(nd1_step)} {card}")
    del real_inputs, nd1_seen, state

    cfg2 = twoply_config(P)
    state2 = P["vec_env"].reset(B_TWOPLY, gen, device=dev)
    state2 = twoply_steps(P, params, state2, cfg2, dev, gen, 2)  # off the opening
    state2, nd_seen, fv_seen = capture_twoply_inputs(P, params, state2, cfg2, dev, gen)
    reply = B_TWOPLY * cfg2.twoply.top_k_candidates
    shapes = [tuple(b.shape[:-1]) for b, _ in fv_seen]
    want = [(B_TWOPLY, 448)] + [(B_TWOPLY, 4, 96)] * 15 + [(B_TWOPLY, 4, 64)] * 3 + [
        (B_TWOPLY, 4, 128)] * 3
    # the step's own moves (two tiers at fast() widths), then the 15 reply rolls
    want_nd = [(B_TWOPLY, 96, 448), (B_TWOPLY // cfg2.movegen.nd_wide_div, 288, 448)] + [
        (reply, 96, 96)] * ND_REPLY_LAUNCHES
    nd_shapes = [(a[0].shape[0], a[7], a[8]) for a in nd_seen]
    if shapes != want or nd_shapes != want_nd:
        raise AssertionError(f"unexpected 2-ply shapes {shapes} {nd_shapes}")
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
    graph_nd = (g1["nd_launches"] + g2["launches"]["nd_tail"]
                + sum(r["launches"]["nd_tail"] for r in gt.values()))
    graph_dd = (g1["dd_launches"] + g2["launches"]["dd_expand"]
                + sum(r["launches"]["dd_expand"] for r in gt.values()))

    take_rows, take_launches = phase_take(P, dev, card)
    phase_arena_card_vs_cpu(P, dev, card)
    ev = phase_eval_graph_vs_eager(P, dev, card)
    cli = phase_evaluate_cli(P, dev, card)
    phase_play_cli(card)
    srt = phase_sorted_engine(P, dev, card)
    mesh = phase_mesh_cli(P, dev, card, train1)
    phase_mesh_world2(card)
    phase_remote_refusal(P, card)
    phase_ring_and_profile(P, dev, gen, card)
    tiered = phase_tiered(P, dev, gen, card, train1)
    gram = phase_gram(P, dev, gen, card)
    scan = phase_scan_and_value_first(P, dev, gen, card)
    phase_probe_xla_modes(P, card)
    stress = phase_stress(P, dev, card)
    guard = phase_guard(P, dev, card)
    parity = phase_parity_and_curve(P, dev, card)
    h2h = phase_head_to_head(P, dev, card)
    bench = phase_bench(P, dev, card, gt["1ply_chunk4"]["ms_per_step"])
    roof = phase_roofline(P, dev, card)
    attr = phase_trace_attr(P, dev, card)
    sweep = phase_sweep_and_spmd(P, dev, card)
    dd = phase_dd_expand(P, params, dev, gen, card)
    mlp = phase_mlp_value(P, dev, gen, card)
    # the measurement tools' launches (phases 39-42), each run counted from 0
    # (bench_spmd's rank is a process of its own)
    bench_tools = {k: sum(r["launches"][k] for r in (*bench.values(), roof, *attr.values(),
                                                      sweep))
                   for k in ("fused_value", "nd_tail")}
    # the tools' launches (phases 35-38), each run counted from 0
    tools_nd = {"stress": stress["a"]["launches"] + stress["b"]["launches"],
                "guard": guard["launches"],
                "parity_train": parity["train_launches"], "curve": parity["curve_launches"],
                "head_to_head": h2h["launches"]}
    # the launches of phases 30-33's timed runs, each counted from 0
    a16 = {k: tiered["eager"]["launches"][k] + tiered["graph"]["launches"][k]
           + tiered["train"]["launches"][k]
           + sum(r["launches"][k] for r in gram.values())
           + sum(r["launches"][k] for r in scan["steps"].values())
           for k in ("fused_value", "nd_tail")}
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
            + sum(t["launches"]["fused_value"] for t in trains.values()) + graph_fv
            + mesh["launches"]["fused_value"] + a16["fused_value"]
            + bench_tools["fused_value"],
            "max_abs_err": max(max_err, fv2_err, tiered["fv_err"],
                               *(r["fv_err"] for r in scan["kernels"].values())),
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
                # phase 29a: the mesh train step at 1 x 1 through the CLI
                "train_mesh": {"launches": mesh["launches"]["fused_value"]},
                # phase 30: the tiered step, [4096, 96] and [512, 448] a step
                "tiered": {"launches": {k: tiered[k]["launches"]["fused_value"]
                                        for k in ("eager", "graph", "train")},
                           **tiered["fv_time"]},
                # phases 31-33: the Gram dedup, the scan and value-first steps
                "gram": {"launches": sum(r["launches"]["fused_value"] for r in gram.values())},
                "scan_and_value_first": {
                    "launches": {k: r["launches"]["fused_value"]
                                 for k, r in scan["steps"].items()},
                    # one launch at [C, 1024, 4, 128], C = roll_chunk
                    "one_launch": {k: {f: r["fused_value_time"][f]
                                       for f in ("ms", "plain_ms", "bound_ms", "bound_by")}
                                   for k, r in scan["kernels"].items()}},
                # phases 39-42: the benches, the roofline, trace_attr, the sweep
                "bench_tools": {"launches": bench_tools["fused_value"]},
            },
            "ok": True,
        },
        {
            "name": "nd_tail",
            "route": "cuda",
            "source": ND_SOURCE,
            "replaces": ND_REPLACES,
            "launches": stats["nd_tail_launches"] + stats2["nd_tail_launches"]
            + sum(t["launches"]["nd_tail"] for t in trains.values()) + graph_nd
            + mesh["launches"]["nd_tail"] + eval_nd + a16["nd_tail"] + sum(tools_nd.values())
            + bench_tools["nd_tail"],
            "max_abs_err": max(nd_err, nd1_err, tiered["nd_err"],
                               *(r.get("nd_err", 0.0) for r in scan["kernels"].values())),
            # one 2-ply step's 17 launches: its own two tiers ([1024, K = 96],
            # [128, K = 288]) and 15 at [4096 rows, K = 96], summed
            "ms": nd_step["ms"],
            "plain_ms": nd_step["plain_ms"],
            "bound_ms": nd_step["bound_ms"],
            "bound_by": nd_step["bound_by"],
            "library_ms": None,
            "ms_per_launch": nd_step["ms"] / nd_step["calls_per_step"],
            "wrapper_ms": nd_step["wrapper_ms"],
            "paths": {# the 1-ply step's two tiers, [4096, K = 96] and [512, K = 288]
                      "1ply": {"launches": stats["nd_tail_launches"],
                               **{k: nd1_step[k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by")}},
                      "2ply": {"launches": stats2["nd_tail_launches"]},
                      **{k: {"launches": t["launches"]["nd_tail"]} for k, t in trains.items()},
                      "graphs": {"launches": graph_nd},
                      # phase 29a: the mesh train step at 1 x 1 through the CLI
                      "train_mesh": {"launches": mesh["launches"]["nd_tail"]},
                      # the graphed matches of phase 25 and the evaluate CLI
                      # runs of phase 26; one launch at [1024, K = 576] timed
                      "eval": {"launches": eval_nd, "K": 576,
                               "ms_per_launch": nd576["ms_per_launch"],
                               "plain_ms": nd576["plain_ms"], "bound_ms": nd576["bound_ms"],
                               "bound_by": nd576["bound_by"]},
                      # phase 30: the tiered wide plane, one launch a step at
                      # [512, K = 288]
                      "tiered": {"launches": {k: tiered[k]["launches"]["nd_tail"]
                                              for k in ("eager", "graph", "train")},
                                 "K": 288, "ms_per_launch": tiered["nd_time"]["ms"],
                                 "plain_ms": tiered["nd_time"]["plain_ms"],
                                 "bound_ms": tiered["nd_time"]["bound_ms"],
                                 "bound_by": tiered["nd_time"]["bound_by"]},
                      # phases 32-33: the scan scorer, 15 launches a step at
                      # chunk 1 and 5 at chunk 3; value-first runs none
                      "scan": {"launches": {k: r["launches"]["nd_tail"]
                                            for k, r in scan["steps"].items()},
                               # one launch at [C x 4096 rows, K = 128]
                               "one_launch": {k: {f: r["nd_tail_time"][f] for f in (
                                   "rows", "ms", "plain_ms", "bound_ms", "bound_by")}
                                   for k, r in scan["kernels"].items() if "nd_tail_time" in r}},
                      # phases 35-38: the stress (a) at [128, K = 576], one
                      # launch timed; the guard, the parity trainer, the
                      # curve and the head-to-head at Config() widths
                      "tools": {"launches": tools_nd, "stress_one_launch": {
                          f: stress["nd_tail_time"][f]
                          for f in ("rows", "K", "ms_per_launch", "plain_ms", "bound_ms",
                                    "bound_by")}},
                      # phases 39-42: the 2-ply benches, the roofline, trace_attr, the sweep
                      "bench_tools": {"launches": bench_tools["nd_tail"]}},
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
    stamp_launches = P["stamp"].KERNEL.launches
    if (stamp_launches > 0) != P["profiling"].tracing():
        raise AssertionError(f"stamp launched {stamp_launches} times with tracing "
                             f"{'on' if P['profiling'].tracing() else 'off'}")
    kernels.append({
        "name": "stamp",
        "route": "cuda",
        "source": STAMP_SOURCE,
        "replaces": None,  # the tracer's clock: no TPU kernel
        # every stamp from the main path's run (phase 4) on: the rollouts'
        # stage stamps, the launch stamps, the learner's
        "launches": stamp_launches,
        # phase 2: the card's ring against the plain one, cell for cell
        "max_abs_err": 0,
        "ms": stamp_check["ms_per_launch"],
        "plain_ms": None,
        "bound_ms": None,
        "bound_by": None,
        "library_ms": None,
        "paths": {"check": {k: stamp_check[k] for k in ("launches", "spin_events_ms",
                                                        "spin_stamps_ms")}},
        "ok": True,
    })
    # the main paths' runs, each counted from 0 just before it and gated at
    # one launch a 1-ply step and seven a 2-ply step
    dd_paths = {"1ply": stats["dd_expand_launches"], "2ply": stats2["dd_expand_launches"],
                **{k: t["launches"]["dd_expand"] for k, t in trains.items()},
                "train_mesh": mesh["launches"]["dd_expand"], "graphs": graph_dd}
    kernels.append({
        "name": "dd_expand",
        "route": "cuda",
        "source": DD_SOURCE,
        "replaces": None,  # JAX runs the doubles enumeration as plain XLA: no TPU kernel
        "launches": sum(dd_paths.values()),
        # phase 43: the largest difference from the plain chain over every
        # output tensor of the two steps' calls
        "max_abs_err": max(v["max_abs_err"] for v in dd.values()),
        # the 1-ply step's one launch, queued behind a spin
        "ms": dd["1ply"]["ms"],
        "plain_ms": dd["1ply"]["plain_ms"],
        "bound_ms": dd["1ply"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "paths": {k: {"launches": n, **{f: dd[k][f] for f in (
            "calls_per_step", "ms", "events_ms", "plain_ms", "bound_ms") if k in dd}}
            for k, n in dd_paths.items()},
        "ok": True,
    })
    kernels.append({
        "name": "mlp_value",
        "route": "cuda",
        "source": MLP_SOURCE,
        "replaces": None,  # the JAX package has no deep net: no TPU kernel
        # phase 44's eager steps, each gated (2 a 1-ply step, 22 a 2-ply step)
        "launches": sum(v["launches"] for v in mlp.values()),
        "max_abs_err": max(v["max_abs_err"] for v in mlp.values()),
        # the 2-ply step's 22 launches, queued behind a spin
        "ms": mlp["2ply"]["ms"],
        "plain_ms": mlp["2ply"]["plain_ms"],
        "bound_ms": mlp["2ply"]["bound_ms"],
        "bound_by": mlp["2ply"]["bound_by"],
        "library_ms": None,
        "paths": {k: {f: v[f] for f in ("launches", "rows", "ms", "every_row_ms", "events_ms",
                                         "plain_ms", "bound_ms")} for k, v in mlp.items()},
        "ok": True,
    })
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
