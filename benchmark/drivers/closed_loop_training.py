"""Traffic kind ``closed_loop_training``: continuous self-play training on
one card, as the program's CLI runs it (``apps.train.train_continuous_single``).

A unit of work is one update: a graphed ``rollout_chunked`` of the
configuration's steps, ``learner.td.update``, one host pull of the update's
metrics. The driver draws every step's noise from ``--seed`` (Gumbel noise,
dice, opening rolls) and feeds it to the rollout; the greedy games, the
first ``greedy_share`` of the batch, get zero sampling noise, so their
choices can be judged one by one without the noise. Set-up builds the
training state from the configuration's weights file and fresh Adam state,
runs the first ``checked_updates`` through the same loop body (the first
captures the rollout's graph) and keeps their trajectories, rolls, losses
and the state the reference compares; the window then runs on that state.

After the window, ``Cell.finish`` replays the first ``resampled_steps``
steps of the last checked update eagerly from its saved start, with the
same noise, and keeps for a sample of the sampled (non-greedy) decisions
the afterstates the program drew among, in the order its noise was laid
over them, with that noise: the reference then judges the timed path's
choice by ``argmax(V / T + g)`` with its own values and temperature.

The driver interface the harness calls: ``set_up`` returns a cell
(``cfg``, ``batch``, ``steps``; ``work``, ``end_to_end``, ``profiled``,
``eager_step``, ``finish``); ``check`` runs the configuration's plain
reference on the record ``finish`` returns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.loader import load_module

TRAJ_FIELDS = {"packed_board": "boards", "player": "player", "reward": "reward",
               "recorded": "recorded", "done": "done", "boundary": "boundary",
               "win_type": "win_type", "close_out": "close_out", "prime": "prime",
               "num_moves": "num_moves", "overflow": "overflow"}
ND_PAIRS = [(i, j) for i in range(1, 7) for j in range(1, 7) if i != j]


def _tupled(x):
    return tuple(_tupled(v) for v in x) if isinstance(x, list) else x


def program_config(conf: dict):
    """The program's ``Config`` from the configuration file's groups, every
    field given there set (lists become the tuples the dataclasses hold),
    with the file's batch."""
    from mlp_ppo_2ply_multi_tpu_torch.core import config as C

    groups = {"model": C.ModelConfig, "env": C.EnvConfig, "movegen": C.MoveGenConfig,
              "train": C.TrainConfig, "twoply": C.TwoPlyConfig}
    parts = {}
    for g, cls in groups.items():
        given = conf.get(g, {})
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(given) - names
        if unknown:
            raise ValueError(f"{g}: no such fields {sorted(unknown)}")
        parts[g] = cls(**{k: _tupled(v) for k, v in given.items()})
    cfg = C.Config(**parts)
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_games=int(conf["batch_games"])))


def weights_path(conf: dict, root: Path) -> Path:
    """The configuration's weights file, refused unless its sha256 is the
    one the configuration pins."""
    path = root / conf["weights"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != conf["weights_sha256"]:
        raise SystemExit(f"benchmark: {conf['weights']} has sha256 {digest}, the configuration "
                         f"pins {conf['weights_sha256']}")
    return path


def temperature(update: int, train: dict) -> float:
    """The sampling temperature of update ``update`` (0-based), worked out
    from the configuration: linear from the initial to the final value over
    ``temperature_decay_updates``, in f32."""
    t0, t1 = np.float32(train["initial_temperature"]), np.float32(train["final_temperature"])
    frac = np.clip(np.float32(update) / np.float32(train["temperature_decay_updates"]),
                   np.float32(0), np.float32(1))
    return float(t0 - (t0 - t1) * frac)


# ---------------------------------------------------------------------------
# the feed: every step's noise, drawn from the seed
# ---------------------------------------------------------------------------


class Feed:
    """Draws the noise of ``steps`` rollout steps at a time on the device,
    in a few large calls, from a generator seeded with the run's seed, and
    wraps each step's slice in the program's noise type. The inputs are the
    benchmark's: a change to the program's own draw cannot change the
    traffic. The first ``greedy`` games (and the first ``greedy`` rows of
    the 1-ply wide sub-batch, where the program samples the greedy games'
    wide decisions) get zero Gumbel noise. ``keep`` holds the dice and
    opening rolls drawn, for the reference."""

    def __init__(self, cfg, seed: int, dev: torch.device, greedy: int):
        from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor

        self.actor, self.cfg, self.dev, self.greedy = actor, cfg, dev, greedy
        self.B = cfg.train.batch_games
        self.gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
        self.pairs = torch.tensor(ND_PAIRS, dtype=torch.int32, device=dev)
        self.t1, self.wn, self.w = actor._noise_shapes(self.B, cfg)
        self.keep: Optional[Dict[str, list]] = None

    def _gumbel(self, shape):
        u = torch.rand(shape, generator=self.gen, device=self.dev, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))

    def rolls(self, shape):
        """Non-double opening rolls [*shape, 2]."""
        return self.pairs[torch.randint(0, 30, shape, generator=self.gen, device=self.dev)]

    def steps(self, n: int) -> list:
        B, G = self.B, self.greedy
        dice = torch.randint(1, 7, (n, B, 2), generator=self.gen, device=self.dev,
                             dtype=torch.int32)
        opener, first = self.rolls((n, B)), self.rolls((n, B))
        if self.keep is not None:
            for k, v in (("next_dice", dice), ("opener", opener), ("first", first)):
                self.keep[k].append(v.cpu().numpy())
        if self.cfg.twoply.enabled:
            g2 = self._gumbel((n, B, self.cfg.twoply.top_k_candidates))
            g1 = self._gumbel((n, B, self.w))
            g2[:, :G] = 0
            g1[:, :G] = 0
            return [self.actor.TwoPlyNoise(g2[i], g1[i], dice[i], opener[i], first[i])
                    for i in range(n)]
        g1 = self._gumbel((n, B, self.t1))
        g2 = self._gumbel((n, self.wn, self.w))
        g1[:, :G] = 0
        g2[:, :G] = 0
        return [self.actor.StepNoise(g1[i], g2[i], dice[i], opener[i], first[i])
                for i in range(n)]


# ---------------------------------------------------------------------------
# the cell: the training state, the games and the loop body
# ---------------------------------------------------------------------------


class Cell:
    """The training state, the games and the loop body of continuous
    training, as the program's CLI runs them on one card."""

    def __init__(self, conf: dict, traffic: dict, seed: int, dev: torch.device, root: Path):
        from mlp_ppo_2ply_multi_tpu_torch.actor import rollout as actor
        from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
        from mlp_ppo_2ply_multi_tpu_torch.learner import td
        from mlp_ppo_2ply_multi_tpu_torch.model import value_net

        self.actor, self.td = actor, td
        self.cfg = program_config(conf)
        tc = self.cfg.train
        if tc.rollout_mode != "continuous" or tc.per_episode_updates:
            raise ValueError("closed_loop_training drives continuous rollouts with the fused "
                             "update (rollout_mode continuous, per_episode_updates false); "
                             "another mode needs a driver of its own")
        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, dev
        self.steps = int(conf["steps_per_update"])
        self.chunk = int(conf["chunk"])
        self.batch = tc.batch_games
        self.greedy = max(1, int(self.batch * float(traffic["greedy_share"])))
        self.feed = Feed(self.cfg, seed, dev, self.greedy)
        self.feed.keep = {"next_dice": [], "opener": [], "first": []}
        self.opener0, self.first0 = self.feed.rolls((self.batch,)), self.feed.rolls((self.batch,))
        params = value_net.load_checkpoint(str(weights_path(conf, root)), device=dev)
        self.state = td.TrainState(params, td.init_adam(params),
                                   torch.zeros((), dtype=torch.int64, device=dev),
                                   torch.zeros((), dtype=torch.int64, device=dev))
        self.env = vec_env.reset_from_rolls(self.opener0, self.first0)
        self.record: dict = {}
        self.start_of_last = None

    def work(self, spans: Optional[list] = None, count: bool = False):
        """One update (``update``); returns the counts or None."""
        return self.update(spans=spans, count=count)[2]

    def update(self, spans: Optional[list] = None, keep_traj: bool = False, count: bool = False):
        """One update: the rollout, the learner, one host pull. ``spans``
        (a list) gets the rollout's and the learner's (name, start, end)
        host times, each ending in a synchronisation; ``count`` adds the
        legal afterstates and the mean nonzero cells of the decisions.
        Returns (metrics dict, trajectory or None, counts or None)."""
        sync = (lambda: torch.cuda.synchronize(self.dev)) if self.dev.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        temp = self.td.temperature(self.state.version, self.cfg)
        noise = self.feed.steps(self.steps)
        self.env, traj = self.actor.rollout_chunked(
            self.state.params, self.env, temp, self.cfg, self.steps, chunk=self.chunk,
            continuous=True, device=self.dev, noise=noise)
        if spans is not None:
            sync()
            t1 = time.perf_counter()
            spans.append(("rollout", t0, t1))
        self.state, metrics = self.td.update(self.state, traj, self.cfg, self.dev)
        metrics["episodes_done"] = traj.boundary.sum()
        if spans is not None:
            sync()
            t2 = time.perf_counter()
            spans.append(("learner", t1, t2))
        counts = None
        if count:
            rec = traj.recorded
            c = traj.packed_board.to(torch.int32)
            nnz = c[..., :48].clamp(0, 4).sum(-1) + (c[..., 48:] > 0).sum(-1)
            counts = torch.stack([traj.num_moves[rec].sum().double(), rec.sum().double(),
                                  nnz[rec].sum().double(),
                                  (rec & (traj.num_moves >= self.cfg.twoply.top_k_candidates)).sum().double()])
        names, vec = self.td.pack_metrics(metrics)
        vals = dict(zip(names, vec.tolist()))
        if spans is not None:
            spans.append(("pull", t2, time.perf_counter()))
        if counts is not None:
            counts = dict(zip(("moves", "decisions", "nnz", "twoply_decisions"),
                              counts.tolist()))
        out_traj = None
        if keep_traj:
            out_traj = {TRAJ_FIELDS[f]: getattr(traj, f).cpu().numpy() for f in TRAJ_FIELDS}
        return vals, out_traj, counts

    def end_to_end(self, times: List[float], window: float) -> dict:
        """The end-to-end metrics the window's update times give."""
        return {"env_steps_per_s": self.batch * self.steps * len(times) / window,
                "update_ms_p90": float(np.percentile(np.asarray(times) * 1e3, 90))}

    def profiled(self, n: int) -> dict:
        """``n`` updates of the loop body under torch.profiler (CPU and CUDA
        activity), with the benchmark's spans; the device's busy and idle
        time and its kernels by name (``trace.device_window``), and the
        counts of the decisions valued."""
        from torch.profiler import profile

        from benchmark import trace as T

        spans: list = []
        counts = []
        _sync(self.dev)
        with profile(activities=_activities(self.dev)) as prof:
            for _ in range(n):
                _, _, c = self.update(spans=spans, count=True)
                counts.append(c)
            _sync(self.dev)
        # the profiler's clock is in microseconds from its own start: align the
        # host spans by the first device event's distance from the rollout span
        starts = [e.time_range.start for e in prof.events() if T._is_device(e)]
        base = min(starts) if starts else 0.0
        off = base - spans[0][1] * 1e6 if spans else 0.0
        sp = [(n_, s * 1e6 + off, e * 1e6 + off) for n_, s, e in spans]
        out = T.device_window(prof, sp)
        out["counts"] = counts
        out["updates"] = n
        out["steps"] = n * self.steps
        return out

    def eager_step(self) -> dict:
        """One eager rollout step from the window's final state, warmed once,
        then profiled: device ms by layer (``trace.stage_times``), the
        kernels' device time by name, and the rows the nd_tail kernel was
        handed (for its bound), all of the same step."""
        from torch.profiler import profile

        from benchmark import trace as T
        from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

        temp = self.td.temperature(self.state.version, self.cfg)
        seen = []
        orig = nd_tail.nd_tail_fused

        def spy(valid, *a, **k):
            seen.append((valid.detach().clone(), int(a[6] if len(a) > 6 else k["K"])))
            return orig(valid, *a, **k)

        def step():
            nz = self.feed.steps(1)[0]
            return self.actor.rollout_step(self.state.params, self.env, temp, self.cfg, True,
                                           noise=nz, device=self.dev)

        step()
        _sync(self.dev)
        nd_tail.nd_tail_fused = spy
        try:
            with profile(activities=_activities(self.dev)) as prof:
                with torch.profiler.record_function("eager_step"):
                    step()
                _sync(self.dev)
        finally:
            nd_tail.nd_tail_fused = orig
        out = T.stage_times(prof)
        out["by_name"] = T.device_window(prof, [])["by_name"]
        out["nd_tail_calls"] = seen
        return out

    def finish(self) -> dict:
        """After the window: the decisions the program drew among, replayed
        eagerly (``resample``), then the program's state and graphs freed.
        Returns the record the reference reads."""
        self.record["sampled"] = self.resample()
        record = self.record
        self.state = self.env = self.start_of_last = None
        if self.dev.type == "cuda":
            from mlp_ppo_2ply_multi_tpu_torch.core.graphs import clear_graphs

            clear_graphs()
            torch.cuda.empty_cache()
        return record

    def resample(self) -> list:
        """Replays the first ``resampled_steps`` steps of the last checked
        update eagerly, from its saved start (the program's params, games
        and version) and with the same noise (a fresh feed from the seed
        draws it again), and keeps, for ``sampled_decisions`` decisions of
        the sampled games drawn from the seed, the afterstates the program
        drew among in the order of their noise, and that noise. Each item
        is (update, step, game, kind, boards int8 [n, 52], noise f32 [n]):
        kind ``1ply`` draws over every legal afterstate, ``2ply`` over the
        reranked candidates."""
        if self.start_of_last is None:
            return []
        u, params, env = self.start_of_last
        tr = self.record["traj"][u]
        S = min(self.steps, int(self.traffic["resampled_steps"]))
        last = u + 1 == len(self.record["traj"])
        rows = [(int(t), int(b)) for t, b in zip(*np.nonzero(tr["recorded"][:S]))
                if b >= self.greedy and not tr["boundary"][t, b] and not tr["overflow"][t, b]
                and (t + 1 < tr["player"].shape[0] or not last)]
        rng = np.random.default_rng([int(self.seed) % (1 << 63), 13])
        n = min(len(rows), int(self.traffic["sampled_decisions"]))
        pick = sorted(rows[i] for i in rng.choice(len(rows), n, replace=False))
        by_step: Dict[int, List[int]] = {}
        for t, b in pick:
            by_step.setdefault(t, []).append(b)
        feed = Feed(self.cfg, self.seed, self.dev, self.greedy)
        feed.rolls((self.batch,))
        feed.rolls((self.batch,))
        for _ in range(u):
            feed.steps(self.steps)
        noise = feed.steps(self.steps)[:S]
        temp = self.td.temperature(torch.tensor(u, device=self.dev), self.cfg)
        out = []
        for t in range(S):
            seen: dict = {}
            with _spied(self.actor, seen):
                env, _ = self.actor.rollout_step(params, env, temp, self.cfg, True,
                                                 noise=noise[t], device=self.dev)
            games = by_step.get(t, [])
            if games:
                out.extend((u, t, b, *c) for b, c in zip(games, _candidates(seen, games)))
        return out


def _spied(actor, seen: dict):
    """Patches the rollout step's sampling calls to keep what they are
    handed: the 1-ply split path's candidate boards (``fused_value``), the
    draws (``sample``) and the wide sub-batch (``_wide_rows``); the 2-ply
    path's ``sampled_logits_2ply``."""
    from mlp_ppo_2ply_multi_tpu_torch.twoply import expectimax

    @contextlib.contextmanager
    def ctx():
        fv, smp, wide, s2 = (actor.fused_value, actor.sample, actor._wide_rows,
                             expectimax.sampled_logits_2ply)

        def fv_spy(boards, *a, **k):
            seen.setdefault("boards", []).append(boards)
            return fv(boards, *a, **k)

        def sample_spy(values, valid, sgn, g, t):
            seen.setdefault("draws", []).append((valid, g))
            return smp(values, valid, sgn, g, t)

        def wide_spy(*a, **k):
            r = wide(*a, **k)
            seen["wide"] = r
            return r

        def s2_spy(params, state, moves, g2, g1, t, cfg):
            r = s2(params, state, moves, g2, g1, t, cfg)
            seen["twoply"] = (moves.boards.data, moves.valid, g2, g1, r.cand, r.use_2ply)
            return r

        actor.fused_value, actor.sample, actor._wide_rows = fv_spy, sample_spy, wide_spy
        expectimax.sampled_logits_2ply = s2_spy
        try:
            yield
        finally:
            actor.fused_value, actor.sample, actor._wide_rows = fv, smp, wide
            expectimax.sampled_logits_2ply = s2

    return ctx()


def _candidates(seen: dict, games: List[int]) -> list:
    """(kind, boards, noise) of each game's draw, from the spied calls."""
    out = []
    if "twoply" in seen:
        boards, valid, g2, g1, cand, use2 = seen["twoply"]
        for b in games:
            if bool(use2[b]):
                out.append(("2ply", boards[b][cand[b]].cpu().numpy(), g2[b].cpu().numpy()))
            else:
                v = valid[b]
                out.append(("1ply", boards[b][v].cpu().numpy(), g1[b][v].cpu().numpy()))
        return out
    (ok1, g1), (ok2, g2) = seen["draws"]
    t1, t2 = seen["boards"]
    _, _, _, in_sub, slot = seen["wide"]
    for b in games:
        if bool(in_sub[b]):
            r = int(slot[b])
            out.append(("1ply", t2[r][ok2[r]].cpu().numpy(), g2[r][ok2[r]].cpu().numpy()))
        else:
            out.append(("1ply", t1[b][ok1[b]].cpu().numpy(), g1[b][ok1[b]].cpu().numpy()))
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _activities(dev: torch.device) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])


def set_up(conf: dict, traffic: dict, seed: int, dev: torch.device, root: Path) -> Cell:
    """The cell, driven from the seed through its first ``checked_updates``
    by the window's own loop body, and the record the reference reads
    (``cell.record``): each update's trajectory (numpy), loss, the rolls
    fed, the program's Adam first moment after the first update and its
    params after the last; and the program's params, games and version at
    the start of the last, which ``resample`` replays from."""
    from mlp_ppo_2ply_multi_tpu_torch.core.tree import tmap

    cell = Cell(conf, traffic, seed, dev, root)
    record = {"traj": [], "loss": []}
    n = int(traffic["checked_updates"])
    for u in range(n):
        if u == n - 1:
            cell.start_of_last = (u, {k: v.detach().clone() for k, v in cell.state.params.items()},
                                  tmap(torch.clone, cell.env))
        vals, traj, _ = cell.update(keep_traj=True)
        record["traj"].append(traj)
        record["loss"].append(vals["loss"])
        if u == 0:
            record["mu1"] = {k: v.detach().cpu() for k, v in cell.state.opt_state.mu.items()}
    record["p_last"] = {k: v.detach().cpu().clone() for k, v in cell.state.params.items()}
    record["rolls"] = {"opener0": cell.opener0.cpu().numpy(), "first0": cell.first0.cpu().numpy(),
                       **{k: np.stack(v) for k, v in cell.feed.keep.items()}}
    cell.feed.keep = None
    cell.record = record
    return cell


# ---------------------------------------------------------------------------
# the reference check
# ---------------------------------------------------------------------------


def check(conf: dict, traffic: dict, record: dict, limits: dict, seed: int,
          dev: torch.device, root: Path, workers: Optional[int] = None,
          control: Optional[str] = None) -> dict:
    """Runs the configuration's plain reference on what the cell recorded
    and compares: env and rules mismatches (exact), the learner's loss,
    first gradient and change of params (gaps by the worst leaf), the
    greedy decisions' gaps (1-ply values, and 2-ply scores where the
    configuration runs 2-ply), and the sampled decisions' gaps of the
    sampled logits (value or score over the temperature, plus the noise the
    program was fed). ``control`` ("tf32_fp8") computes the learner in TF32
    and the choices by fp8 values in the program's place. Returns the
    numbers, ``compared`` (name, number, limit) and ``correct``."""
    R = load_module(root, "reference", conf["reference"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workers = int(traffic.get("oracle_workers", 1)) if workers is None else workers
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    p0 = R.load_params(str(weights_path(conf, root)), dev)
    hp = R.Hyper(conf["train"])
    nums: Dict[str, float] = {}
    learn = R.check_learner(p0, record, hp, dev, tf32=control is not None)
    nums.update({k: learn[k] for k in ("loss_gap", "grad_gap", "step_gap")})
    # the params each checked update played with, by the f32 reference
    P = (R.check_learner(p0, record, hp, dev) if control else learn)["params"]
    dice, _, n_bad = R.replay_env(record, conf["env"])
    nums["env_mismatch"] = float(n_bad)
    given = R.shaping_given(record)
    B = record["traj"][0]["player"].shape[1]
    G = max(1, int(B * float(traffic["greedy_share"])))
    rows_any, rows_greedy = R.sample_rows(record, rng, int(traffic["legality_decisions"]),
                                          int(traffic["greedy_decisions"]), G)
    sampled = record.get("sampled", [])
    two_s = [i for i, x in enumerate(sampled) if x[3] == "2ply"]
    n2 = int(traffic.get("twoply_decisions", 0))
    if len(two_s) > n2:
        rng_s = np.random.default_rng([int(seed) % (1 << 63), 17])
        keep = set(rng_s.choice(two_s, n2, replace=False).tolist())
        sampled = [x for i, x in enumerate(sampled) if x[3] != "2ply" or i in keep]
    rows_s = [(u, t, b) for u, t, b, *_ in sampled]
    dec = R.Decisions(rows_any + rows_greedy + rows_s, record, dice)
    R.enumerate_legal(dec, workers)
    n_any, n_greedy = len(rows_any), len(rows_greedy)
    n_rules, notes = R.check_rules(dec, record, conf["env"], given)
    nums["rules_mismatch"] = float(n_rules)
    ctl = "fp8" if control else None
    sub = lambda idx: _subset(R, dec, [n_any + i for i in idx], record, dice)
    tw = conf.get("twoply", {})
    extra = {}
    idx1 = list(range(n_greedy))
    replies = []
    if tw.get("enabled"):
        k = int(tw["top_k_candidates"])
        n_legal = [len(dec.legal[n_any + i]) for i in idx1]
        two = [i for i in idx1 if n_legal[i] >= k]
        idx1 = [i for i in idx1 if n_legal[i] < k]
        rng2 = np.random.default_rng([int(seed) % (1 << 63), 11])
        if two:
            two = sorted(rng2.choice(two, min(len(two), int(traffic["twoply_decisions"])),
                                     replace=False).tolist())
            gaps2, rep = R.gaps_2ply(P, sub(two), tw, dev, workers, ctl)
            replies.append(rep)
        else:
            gaps2 = np.zeros(0)
        nums["twoply_gap"] = _worst(gaps2)
        extra.update(twoply_checked=len(two), gaps2=gaps2)
    gaps1 = R.gaps_1ply(P, sub(idx1), dev, ctl)
    nums["choice_gap"] = _worst(gaps1)
    extra.update(greedy_checked=len(gaps1), gaps1=gaps1)
    # the sampled decisions: the program's draw judged with its noise
    items = [(kind, boards, noise) for _, _, _, kind, boards, noise in sampled]
    idx_s = list(range(n_any + n_greedy, n_any + n_greedy + len(sampled)))
    temps = [temperature(u, conf["train"]) for u, _, _ in rows_s]
    sg = R.gaps_sampled(P, _subset(R, dec, idx_s, record, dice), items, temps, tw, dev, workers,
                        ctl)
    nums["sampled_gap"] = _worst(sg["1ply"])
    if tw.get("enabled"):
        nums["sampled_twoply_gap"] = _worst(sg["2ply"])
        replies.append(sg["replies"])
    extra.update(sampled_checked=len(sampled), sampled_1ply=len(sg["1ply"]),
                 sampled_2ply=len(sg["2ply"]), sampled_notes=sg["notes"])
    if replies:
        rows = sum(r[0] for r in replies)
        cands = sum(r[1] for r in replies)
        extra["replies_per_candidate"] = rows / cands if cands else 0.0
    compared = []
    for name in limits:
        compared.append((name, nums[name], float(limits[name])))
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in compared)
    learn = {k: v for k, v in learn.items() if k != "params"}
    return {"correct": bool(ok), "numbers": nums, "compared": compared,
            "notes": notes + sg["notes"][:3], "learner": learn, **extra,
            "legality_checked": n_any}


def _subset(R, dec, idx, record, dice):
    idx = list(idx)
    s = R.Decisions([dec.rows[i] for i in idx], record, dice)
    s.legal = [dec.legal[i] for i in idx]
    return s


def _worst(g: np.ndarray) -> float:
    if len(g) == 0:
        return 0.0
    return float("inf") if np.isnan(g).any() else float(g.max())
