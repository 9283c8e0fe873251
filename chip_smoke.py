#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

The main path is the 1-ply production self-play step
(``mlp_ppo_2ply_multi_tpu_torch.actor.rollout.rollout_step`` under
``Config.production()``: split planes, two-tier candidate evaluation through
the fused board -> value CUDA kernel, bf16 value net) at B = 4096 games,
continuous mode, with the in-repo checkpoint's weights. Phases, in order;
any failure exits non-zero:

1. device: torch's view of the card and nvidia-smi's name and power limit;
2. build: nvcc builds ops/csrc/fused_value.cu (seconds, registers, spills);
3. kernel vs plain: the kernel against ``fused_value_plain`` at the main
   path's two shapes, on random in-domain boards and on the real candidate
   boards of a production step;
4. main path: warm-up, then timed production steps with the launch count
   read around them (two launches per step);
5. same step, kernel vs plain: one step from the same state and noise;
   decisions agree on >= 99.9% of rows and the integer state is identical
   on agreeing rows;
6. card vs CPU: one step at B = 256 on the card and through the port's CPU
   path (which the CPU tests hold against the JAX package) — bit-equal
   legal moves, identical integer state on agreeing rows;
7. where the time goes: per-stage host times and a torch.profiler window;
8. kernel timing and bound, then the kernels line and the result line.

It imports torch, numpy and the port only. Without CUDA, or without the
port beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
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
KERNEL_SOURCE = "mlp_ppo_2ply_multi_tpu_torch/ops/csrc/fused_value.cu"
KERNEL_REPLACES = "mlp_ppo_2ply_multi_tpu/ops/fused_value.py:93"


def log(*args) -> None:
    print(*args, flush=True)


def _port():
    """Import the port from this checkout (never an installed copy)."""
    sys.path.insert(0, str(ROOT))
    import mlp_ppo_2ply_multi_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError(f"port imported from {pkg.__file__}, not {ROOT}")
    from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
    from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
    from mlp_ppo_2ply_multi_tpu_torch.encoder.features import encode_board
    from mlp_ppo_2ply_multi_tpu_torch.engine import board, movegen2
    from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
    from mlp_ppo_2ply_multi_tpu_torch.model import value_net
    from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value

    return dict(
        rollout=rollout, Config=Config, encode_board=encode_board, board=board,
        movegen2=movegen2, vec_env=vec_env, value_net=value_net, fv=fused_value,
    )


def production_config(P):
    """Config.production() with td_mode "side0", the mode the in-repo
    checkpoint was trained in (side-0 values; side 1 minimizes)."""
    cfg = P["Config"].production()
    return cfg.replace(train=dataclasses.replace(cfg.train, td_mode="side0"))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _ValueFn:
    """Swap the actor's value function for a while (plain version or a
    capturing wrapper) and put the original back."""

    def __init__(self, P, fn):
        self.mod, self.fn = P["rollout"], fn

    def __enter__(self):
        self.saved = self.mod.fused_value
        self.mod.fused_value = self.fn

    def __exit__(self, *exc):
        self.mod.fused_value = self.saved


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


def phase_build(P):
    t0 = time.perf_counter()
    P["fv"].KERNEL.load()
    info = P["fv"].KERNEL.build_info
    log(f"[2 build] {info.get('path')} cached={info.get('cached')} "
        f"nvcc_s={info.get('seconds', 0.0):.2f} load_s={time.perf_counter() - t0:.2f}")
    for line in str(info.get("ptxas", "")).splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
            log(f"[2 build] ptxas: {line.strip()}")


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


def phase_kernel_vs_plain(P, params, real_inputs, dev, gen, card):
    fv = P["fv"]
    cases = []
    for shape in ((B_PROD, 96), (256, 448)):
        boards = torch.randint(0, 16, (*shape, 52), generator=gen, device=dev).to(torch.int8)
        flag = torch.randint(0, 2, (shape[0], 1), generator=gen, device=dev)
        cases.append((f"random{list(shape)}", boards, flag))
    for i, (boards, flag) in enumerate(real_inputs):
        cases.append((f"step_tier{i + 1}{list(boards.shape[:-1])}", boards, flag))
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
        log(f"[3 kernel vs plain] {name}: max|dv|={mx:.3e} mean|dv|={mean:.3e} "
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
    to_cpu = lambda x: type(x)(*(to_cpu(v) if hasattr(v, "_fields") else v.cpu() for v in x))
    state_c, noise_c = to_cpu(state), to_cpu(noise)
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


def phase_time_breakdown(P, params, state, cfg, dev, gen, step_ms, card):
    """Per-stage host times (synchronised), and the device's busy share
    from a torch.profiler window."""
    R, mg2, VE = P["rollout"], P["movegen2"], P["vec_env"]
    b = state.player.shape[0]
    temp = torch.tensor(cfg.train.initial_temperature, device=dev)
    stages = dict(noise=0.0, movegen=0.0, obs_value=0.0, select=0.0, env=0.0)
    n = 8
    for _ in range(n):
        marks = [time.perf_counter()]
        noise = R.draw_noise(b, cfg, gen, dev)
        _sync(dev); marks.append(time.perf_counter())
        sm = mg2.legal_moves_split(state.board, state.player, state.dice, cfg.movegen)
        _sync(dev); marks.append(time.perf_counter())
        P["value_net"].forward(params, P["encode_board"](state.board, state.player), cfg.model)
        _sync(dev); marks.append(time.perf_counter())
        sgn = torch.where(state.player == 0, 1.0, -1.0)
        _, chosen, _ = R._select_action_split(
            params, sm, 1 - state.player, sgn, noise.gumbel_t1, noise.gumbel_t2, temp, cfg
        )
        _sync(dev); marks.append(time.perf_counter())
        res = VE.step_chosen(state, sm.count, chosen, noise.next_dice, cfg.env)
        done = res.done | (~res.state.game_over & (res.state.step_count >= cfg.env.max_timesteps))
        state = VE.reset_where(done, res.state, noise.reset_opener, noise.reset_first)
        _sync(dev); marks.append(time.perf_counter())
        for k, (t0, t1) in zip(stages, zip(marks, marks[1:])):
            stages[k] += (t1 - t0) * 1e3 / n
    log(f"[7 time] per-stage ms/step (synchronised): "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} {card}")

    from torch.profiler import ProfilerActivity, profile

    steps = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = R.rollout_step(
                params, state, cfg.train.initial_temperature, cfg, True, gen=gen, device=dev
            )
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    dev_t = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0
    )
    busy_us = sum(dev_t(e) for e in ev)
    n_kern = sum(e.count for e in ev if dev_t(e) > 0)
    if busy_us > 0:
        busy_ms = busy_us / steps / 1e3
        # the profiler slows the host, so the traced wall overstates the step;
        # the idle share of the untraced step uses phase 4's ms/step
        log(f"[7 time] profiler: device busy {busy_ms:.3f} ms/step of "
            f"{wall_us / steps / 1e3:.3f} ms/step traced wall (idle share "
            f"{1 - busy_us / wall_us:.3f}); of the untraced {step_ms:.3f} ms/step "
            f"(idle share {1 - busy_ms / step_ms:.3f}); "
            f"{n_kern / steps:.0f} device ops/step {card}")
        top = sorted(ev, key=dev_t, reverse=True)[:10]
        for e in top:
            log(f"[7 time]   {dev_t(e) / steps / 1e3:8.3f} ms/step  x{e.count // steps:<4d} "
                f"{e.key[:90]}")
    else:
        log("[7 time] profiler: device time not measured (no CUDA events)")


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
    head) over the bf16 peak. Also the dense count of the 208 x h layer."""
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
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def phase_kernel_timing(P, params, real_inputs, dev, card):
    """Per main-path shape: the kernel alone (launches on operands laid out
    once), the whole wrapper as the main path calls it (params recombined on
    every call), and the plain version. The inputs stay in L2 between
    launches, as the main path's freshly gathered tier tensors do."""
    fv = P["fv"]
    per = []
    for boards, flag in real_inputs:
        ops = fv.kernel_operands(boards, flag, params)
        kern = lambda: fv.launch_kernel(*ops)
        wrap = lambda: fv.fused_value(boards, flag, params)
        plain = lambda: fv.fused_value_plain(boards, flag, params)
        # plain, kernel, wrapper, wrapper, kernel, plain in one call on one card
        p1, k1, w1, w2, k2, p2 = (
            _time_ms(f, dev) for f in (plain, kern, wrap, wrap, kern, plain)
        )
        bd = kernel_bound(boards)
        row = dict(shape=list(boards.shape[:-1]), ms=(k1 + k2) / 2, wrapper_ms=(w1 + w2) / 2,
                   plain_ms=(p1 + p2) / 2, runs_ms=[p1, k1, w1, w2, k2, p2], **bd)
        per.append(row)
        log(f"[8 kernel time] {json.dumps(row)} {card}")
    return per


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
    per = phase_kernel_timing(P, params, real_inputs, dev, card)

    kernels = [{
        "name": "fused_value",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": stats["fused_value_launches"],
        "max_abs_err": max_err,
        # one production step's two launches (tier 1 + tier 2), summed
        "ms": sum(r["ms"] for r in per),
        "plain_ms": sum(r["plain_ms"] for r in per),
        "bound_ms": sum(r["bound_ms"] for r in per),
        "bound_by": "bytes" if sum(r["bytes_ms"] for r in per) >= sum(r["ops_ms"] for r in per)
        else "operations",
        "library_ms": None,
        "ok": True,
    }]
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
