"""Plain reference of continuous TD(0) self-play training, for ``correct``.

Plain PyTorch, NumPy and the frozen rules (``rules.py``); it imports nothing
of the program and takes nothing the program made except the outputs it
judges. It works out again:

* the value net (198 -> hidden -> 1, sigmoid hidden, linear head) from the
  checkpoint file, in float32 with TF32 off;
* the learner: TD(0) targets (side0 signs, bootstrapped from the next
  recorded step of the same game, never across an episode boundary), the
  per-game masked mean squared error, the clip by global norm (no epsilon)
  and Adam, step after step on the program's trajectories;
* the environment: who moves, the dice, resets, passes, truncation at the
  step cap and the episode boundaries, on every row of the trajectories;
  on a sample of decisions the legal afterstates, their count, the win
  type and the shaping rewards;
* the actor on the greedy games (their sampling noise is zero): the gap by
  which the program's afterstate lies below the best one, by the 1-ply
  value or, where the configuration runs 2-ply, by the 2-ply score (the
  top-k candidates by value reranked by value minus beta times the
  expected mean of the opponent's top replies over the 21 rolls);
* the actor on a sample of the sampled games: the gap by which the
  program's afterstate's sampled logit (value or 2-ply score over the
  temperature, plus the Gumbel noise the program was fed for it) lies
  below the largest of its draw (``gaps_sampled``).

The learner and the gaps can also be computed a precision lower than the
configuration states (TF32 matmuls, fp8 values): those are the controls.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import jobs as jobs_mod
from benchmark.reference import rules

N_CELLS = 52
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ROLLS = jobs_mod.ROLLS
PROBS = [(1.0 if a == b else 2.0) / 36.0 for a, b in ROLLS]
INITIAL = rules.cells(rules.start_board())
# value units: a 2-ply candidate within this of the first value below the
# top-k may fall on either side of the cut in bf16 (1-ply greedy gaps of
# sound runs, bf16 against f32 values, reach 0.0054 on the card)
TOPK_MARGIN = 0.01


# ---------------------------------------------------------------------------
# value net
# ---------------------------------------------------------------------------


def load_params(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict (fc1.weight [h, 198], fc1.bias,
    value_head.weight [1, h], value_head.bias) as f32 w1 [198, h], b1 [h],
    w2 [h, 1], b2 [1] on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    f = lambda k: sd[k].detach().to(torch.float32)
    return {
        "w1": f("fc1.weight").T.contiguous().to(device),
        "b1": f("fc1.bias").clone().to(device),
        "w2": f("value_head.weight").T.contiguous().to(device),
        "b2": f("value_head.bias").clone().to(device),
    }


def encode(cells: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """Tesauro's 198 features of 52-cell rows [..., 52] with side-to-move
    ``flag`` (broadcast to the rows' batch shape): for each of the 48 point
    cells (>= 1, >= 2, >= 3, (n - 3) / 2 at least 0); bar p0 / 2, off p0 /
    15, bar p1 / 2, off p1 / 15; then the one-hot of the flag."""
    c = cells.to(torch.float32)
    pts = c[..., :48]
    per_point = torch.stack(
        [(pts >= 1).float(), (pts >= 2).float(), (pts >= 3).float(), (pts - 3).clamp_min(0) / 2],
        -1,
    ).flatten(-2)
    f = torch.broadcast_to(torch.as_tensor(flag, device=c.device), c.shape[:-1])
    tail = torch.stack(
        [c[..., 48] / 2, c[..., 50] / 15, c[..., 49] / 2, c[..., 51] / 15,
         (f == 0).float(), (f == 1).float()], -1)
    return torch.cat([per_point, tail], -1)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), back in float32: what an fp8 operand holds."""
    s = x.abs().max().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def value(params, feats: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """V(features) -> [...] f32; ``precision`` "fp8" rounds both products'
    operands to fp8 (the control), accumulating in f32."""
    w1, b1, w2, b2 = params["w1"], params["b1"], params["w2"], params["b2"]
    if precision == "fp8":
        feats, w1, w2 = _fp8(feats), _fp8(w1), _fp8(w2)
    h = torch.sigmoid(feats @ w1 + b1)
    if precision == "fp8":
        h = _fp8(h)
    return (h @ w2 + b2)[..., 0]


def values_of(params, cells: np.ndarray, flag: np.ndarray, device, precision="f32",
              owner: Optional[np.ndarray] = None, block: int = 1 << 18) -> np.ndarray:
    """Values of int8 rows [n, 52] with flags [n], in blocks of rows.
    ``params`` is one set, or a list with ``owner`` [n] naming the set that
    values each row."""
    if owner is not None:
        out = np.zeros(len(cells), np.float32)
        for u in np.unique(owner):
            m = owner == u
            out[m] = values_of(params[int(u)], cells[m], flag[m], device, precision)
        return out
    out = []
    for i in range(0, len(cells), block):
        c = torch.as_tensor(cells[i:i + block], device=device)
        f = torch.as_tensor(flag[i:i + block], device=device)
        with torch.no_grad():
            out.append(value(params, encode(c, f), precision).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


# ---------------------------------------------------------------------------
# learner
# ---------------------------------------------------------------------------


class Hyper:
    """The learner's settings, read from the configuration's ``train``
    group: gamma, learning rate, grad clip, td_mode (side0 only)."""

    def __init__(self, train: dict):
        if train.get("td_mode") != "side0":
            raise ValueError("the reference learner implements td_mode side0")
        if train.get("lr_decay", 1.0) < 1.0:
            raise ValueError("the reference learner has no learning-rate decay")
        self.gamma = float(train["gamma"])
        self.lr = float(train["learning_rate"])
        self.clip = float(train["grad_clip"])


def targets_plan(reward, recorded, boundary, player):
    """Per step (t, game): the signed reward, the index of the next recorded
    step of that game and whether the target bootstraps from it (a next
    recorded step exists and no boundary lies in [t, next))."""
    T, B = reward.shape
    signed = torch.where(player == 0, reward, -reward)
    nxt = torch.zeros((T, B), dtype=torch.int64, device=reward.device)
    has = torch.zeros((T, B), dtype=torch.bool, device=reward.device)
    nrec = torch.full((B,), T, dtype=torch.int64, device=reward.device)
    clear = torch.ones(B, dtype=torch.bool, device=reward.device)
    for t in reversed(range(T)):
        nxt[t] = nrec.clamp_max(T - 1)
        has[t] = (nrec < T) & clear & ~boundary[t]
        clear = torch.where(recorded[t], torch.ones_like(clear), clear & ~boundary[t])
        nrec = torch.where(recorded[t], torch.full_like(nrec, t), nrec)
    return signed, nxt, has


def learner_step(params, adam, traj: dict, hp: Hyper, tf32: bool = False):
    """One fused TD(0) update over the [T, B] trajectory ``traj`` (boards,
    player, reward, recorded, boundary as tensors on the params' device).
    Returns (loss, the clipped gradient by leaf, new params, new Adam state
    (count, mu, nu)). ``tf32`` runs the products in TF32 (the control)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        feats = encode(traj["boards"], traj["player"])
        m = traj["recorded"].float()
        with torch.enable_grad():
            v = value(leaves, feats)
            signed, nxt, has = targets_plan(traj["reward"], traj["recorded"],
                                            traj["boundary"], traj["player"])
            vd = v.detach()
            target = signed + torch.where(has, hp.gamma * torch.gather(vd, 0, nxt), 0.0)
            err = (v - target) * m
            loss = ((err * err).sum(0) / m.sum(0).clamp_min(1.0)).mean()
            keys = sorted(leaves)
            grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads)))
    if not bool(norm < hp.clip):
        grads = {k: g / norm * hp.clip for k, g in grads.items()}
    count, mu, nu = adam
    count += 1
    new_mu = {k: (1 - ADAM_B1) * grads[k] + ADAM_B1 * mu[k] for k in grads}
    new_nu = {k: (1 - ADAM_B2) * grads[k] * grads[k] + ADAM_B2 * nu[k] for k in grads}
    bc1, bc2 = 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count
    new_params = {
        k: params[k] - hp.lr * (new_mu[k] / bc1) / (torch.sqrt(new_nu[k] / bc2) + ADAM_EPS)
        for k in params
    }
    return float(loss.detach()), grads, new_params, (count, new_mu, new_nu)


def fresh_adam(params):
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return 0, zeros, dict(zeros)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap of norms: |‖prog‖ - ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖. Returns (gap, leaf)."""
    keys = sorted(ref) if keep is None else list(keep)
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in sorted(ref)}
    med = float(np.median(list(norms.values())))
    worst, leaf = 0.0, ""
    for k in keys:
        g = abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k]) / max(norms[k], med, 1e-30)
        if g >= worst:
            worst, leaf = g, k
    return worst, leaf


def check_learner(p0, record, hp: Hyper, device, tf32: bool = False) -> dict:
    """Follow the program's first updates from the checkpoint's params
    ``p0`` and fresh Adam state, on its trajectories (``record["traj"]``,
    one dict of numpy arrays an update). Compares each update's loss with
    ``record["loss"]``, the first clipped gradient with the one the
    program's Adam state implies (``record["mu1"]`` / (1 - b1)), and the
    change of the params after the last update with ``record["p_last"]``
    minus ``p0``, leaving out leaves whose first gradient is under a
    thousandth of the median leaf's. ``params`` holds the reference's params
    before each update and after the last."""
    params, adam = dict(p0), fresh_adam(p0)
    loss_gap, grads1 = 0.0, None
    seq = [dict(p0)]
    for u, tr in enumerate(record["traj"]):
        t = {k: torch.as_tensor(tr[k], device=device)
             for k in ("boards", "player", "reward", "recorded", "boundary")}
        loss, grads, params, adam = learner_step(params, adam, t, hp, tf32)
        loss_gap = max(loss_gap, abs(record["loss"][u] - loss) / max(abs(loss), 1e-30))
        if grads1 is None:
            grads1 = grads
        seq.append(params)
    g_prog = {k: torch.as_tensor(v, device=device) / (1 - ADAM_B1) for k, v in record["mu1"].items()}
    grad_gap, grad_leaf = leaf_gap(g_prog, grads1)
    gn = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads1.items()}
    med = float(np.median(list(gn.values())))
    moving = [k for k in sorted(gn) if gn[k] >= 1e-3 * med]
    d_prog = {k: torch.as_tensor(record["p_last"][k], device=device) - p0[k] for k in p0}
    d_ref = {k: params[k] - p0[k] for k in p0}
    step_gap, step_leaf = leaf_gap(d_prog, d_ref, moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "step_gap": step_gap,
            "grad_leaf": grad_leaf, "step_leaf": step_leaf,
            "leaves_left_out": float(len(gn) - len(moving)), "params": seq}


# ---------------------------------------------------------------------------
# environment, on every row
# ---------------------------------------------------------------------------


def replay_env(record, env: dict) -> Tuple[np.ndarray, np.ndarray, int]:
    """Works out who moves, the dice and the step counts of every row from
    the injected rolls and the trajectories' boundaries, and checks the
    rows against them. Returns (dice [U, T, B, 2], the mismatches by row
    [U, T, B] bool, how many rows mismatch)."""
    trajs, rolls = record["traj"], record["rolls"]
    B = trajs[0]["player"].shape[1]
    opener, first = rolls["opener0"], rolls["first0"]
    player = (opener[:, 0] < opener[:, 1]).astype(np.int32)
    dice = first.astype(np.int32).copy()
    board = np.broadcast_to(np.asarray(INITIAL, np.int8), (B, N_CELLS)).copy()
    steps = np.zeros(B, np.int64)
    cap = int(env["max_timesteps"])
    all_dice, bad = [], []
    for u, tr in enumerate(trajs):
        T = tr["player"].shape[0]
        d_u = np.zeros((T, B, 2), np.int32)
        bad_u = np.zeros((T, B), bool)
        for t in range(T):
            d_u[t] = dice
            bad_u[t] |= tr["player"][t] != player
            bad_u[t] |= (tr["boards"][t] != board).any(-1)
            steps = steps + 1
            bnd = tr["done"][t] | (steps >= cap)
            bad_u[t] |= tr["boundary"][t] != bnd
            nd, ro, rf = (rolls[k][u][t] for k in ("next_dice", "opener", "first"))
            # the board after the move is the next row's; rows that pass keep it
            if t + 1 < T:
                nxt_board = tr["boards"][t + 1]
            elif u + 1 < len(trajs):
                nxt_board = trajs[u + 1]["boards"][0]
            else:
                nxt_board = None
            passed = ~tr["recorded"][t] & ~bnd
            if nxt_board is not None:
                bad_u[t] |= passed & (nxt_board != tr["boards"][t]).any(-1)
                board = np.where(bnd[:, None], np.asarray(INITIAL, np.int8), nxt_board)
            player = np.where(bnd, (ro[:, 0] < ro[:, 1]).astype(np.int32), 1 - player)
            dice = np.where(bnd[:, None], rf, nd).astype(np.int32)
            steps = np.where(bnd, 0, steps)
        all_dice.append(d_u)
        bad.append(bad_u)
    bad_a = np.stack(bad)
    return np.stack(all_dice), bad_a, int(bad_a.sum())


def shaping_given(record) -> Tuple[np.ndarray, np.ndarray]:
    """Per row, whether the mover's close-out and five-prime bonuses were
    already given earlier in the episode (the trajectories hold every step
    of every episode since the first reset)."""
    out_c, out_p = [], []
    B = record["traj"][0]["player"].shape[1]
    gc = np.zeros((B, 2), bool)
    gp = np.zeros((B, 2), bool)
    idx = np.arange(B)
    for tr in record["traj"]:
        T = tr["player"].shape[0]
        c_u = np.zeros((T, B), bool)
        p_u = np.zeros((T, B), bool)
        for t in range(T):
            pl = tr["player"][t].astype(np.int64)
            c_u[t] = gc[idx, pl]
            p_u[t] = gp[idx, pl]
            gc[idx, pl] |= tr["close_out"][t]
            gp[idx, pl] |= tr["prime"][t]
            bnd = tr["boundary"][t]
            gc[bnd] = False
            gp[bnd] = False
        out_c.append(c_u)
        out_p.append(p_u)
    return np.stack(out_c), np.stack(out_p)


# ---------------------------------------------------------------------------
# decisions: legal afterstates and the greedy choices
# ---------------------------------------------------------------------------


def _orient(v: np.ndarray, mover: int) -> np.ndarray:
    """Values higher-is-better for ``mover`` (side0: side 1 minimizes)."""
    return v if mover == 0 else -v


class Decisions:
    """The sampled decisions and everything the reference found about them."""

    def __init__(self, rows: List[Tuple[int, int, int]], record, dice):
        self.rows = rows
        tr = record["traj"]
        self.board = [tr[u]["boards"][t, b] for u, t, b in rows]
        self.player = [int(tr[u]["player"][t, b]) for u, t, b in rows]
        self.dice = [tuple(int(x) for x in dice[u, t, b]) for u, t, b in rows]
        self.after = []  # the program's afterstate, None where not observable
        for u, t, b in rows:
            T = tr[u]["boards"].shape[0]
            if tr[u]["boundary"][t, b]:
                self.after.append(None)
            elif t + 1 < T:
                self.after.append(tr[u]["boards"][t + 1, b])
            elif u + 1 < len(tr):
                self.after.append(tr[u + 1]["boards"][0, b])
            else:
                self.after.append(None)
        self.legal: List[np.ndarray] = []


def sample_rows(record, rng: np.random.Generator, n_any: int, n_greedy: int,
                greedy_games: int) -> Tuple[list, list]:
    """(rows for the legality checks: decisions drawn from every game;
    greedy rows: decisions of the greedy games whose afterstate is seen and
    whose move set the program reports whole). Rows are (update, t, game)."""
    any_rows, greedy_rows = [], []
    for u, tr in enumerate(record["traj"]):
        rec = tr["recorded"]
        T = rec.shape[0]
        last_seen = u + 1 < len(record["traj"])
        for t, b in zip(*np.nonzero(rec)):
            any_rows.append((u, int(t), int(b)))
            if (b < greedy_games and not tr["boundary"][t, b] and not tr["overflow"][t, b]
                    and (t + 1 < T or last_seen)):
                greedy_rows.append((u, int(t), int(b)))
    pick = lambda rows, n: [rows[i] for i in sorted(rng.choice(len(rows), min(n, len(rows)),
                                                               replace=False))]
    return pick(any_rows, n_any), pick(greedy_rows, n_greedy)


def check_rules(dec: Decisions, record, env: dict, given) -> Tuple[int, List[str]]:
    """Exact checks of sampled decisions: the program's afterstate is legal;
    its legal-move count equals the reference's where it reports no
    overflow; a game won on the step could be won so, with its win type;
    the shaping flags and the reward follow from the afterstate. Returns
    (mismatches, the first few described)."""
    tr = record["traj"]
    bad, notes = 0, []
    for i, (u, t, b) in enumerate(dec.rows):
        row = {k: tr[u][k][t, b] for k in ("num_moves", "overflow", "done", "win_type",
                                           "close_out", "prime", "reward")}
        p = dec.player[i]
        legal = dec.legal[i]
        keys = {x.tobytes() for x in legal}
        why = []
        if not row["overflow"] and int(row["num_moves"]) != len(legal):
            why.append(f"count {int(row['num_moves'])} != {len(legal)}")
        if row["done"]:
            wins = [rules.board_from_cells(a) for a in legal
                    if rules.won(rules.board_from_cells(a), p)]
            types = {3 if rules.backgammon(w, p) else 2 if rules.gammon(w, p) else 1
                     for w in wins}
            if int(row["win_type"]) not in types:
                why.append(f"win type {int(row['win_type'])} not among {sorted(types)}")
            want = {1: env["reward_win_normal"], 2: env["reward_win_gammon"],
                    3: env["reward_win_backgammon"]}.get(int(row["win_type"]), math.nan)
            if not math.isclose(float(row["reward"]), want, rel_tol=0, abs_tol=1e-6):
                why.append(f"win reward {float(row['reward'])} != {want}")
        elif dec.after[i] is not None:
            a = dec.after[i]
            if a.tobytes() not in keys:
                why.append("afterstate not legal")
            ab = rules.board_from_cells(a)
            if rules.won(ab, p):
                why.append("a winning move not marked done")
            co = rules.closed_out(ab, p) and not given[0][u, t, b]
            pr = rules.five_prime(ab, p) and not given[1][u, t, b]
            shaping = env.get("shaping_rewards", True)
            if shaping and (bool(row["close_out"]) != co or bool(row["prime"]) != pr):
                why.append(f"shaping flags {bool(row['close_out'])},{bool(row['prime'])} != {co},{pr}")
            want = (env["reward_close_out"] * co + env["reward_five_prime"] * pr) if shaping else 0.0
            if not math.isclose(float(row["reward"]), want, rel_tol=0, abs_tol=1e-6):
                why.append(f"reward {float(row['reward'])} != {want}")
        if why:
            bad += 1
            if len(notes) < 5:
                notes.append(f"update {u + 1} step {t} game {b}: " + "; ".join(why))
    return bad, notes


def _flat(dec: Decisions, idx=None):
    """The legal afterstates of decisions ``idx`` (all by default) as one
    array, their side-to-move flags for valuing (side0: the mover's
    opponent on roll), the update that owns each row, and the offsets."""
    idx = range(len(dec.legal)) if idx is None else idx
    legal = [dec.legal[i] for i in idx]
    flat = np.concatenate(legal) if legal else np.zeros((0, N_CELLS), np.int8)
    flags = np.concatenate([np.full(len(dec.legal[i]), 1 - dec.player[i]) for i in idx]) \
        if legal else np.zeros(0)
    owner = np.concatenate([np.full(len(dec.legal[i]), dec.rows[i][0]) for i in idx]) \
        if legal else np.zeros(0)
    at = np.cumsum([0] + [len(l) for l in legal])
    return flat, flags.astype(np.int64), owner.astype(np.int64), at


def _chosen(dec: Decisions, i: int) -> int:
    """Index of the program's afterstate among decision i's legal ones, -1
    where it is not one of them."""
    a = dec.after[i]
    if a is None:
        return -1
    key = a.tobytes()
    return next((j for j, x in enumerate(dec.legal[i]) if x.tobytes() == key), -1)


def gaps_1ply(P: list, dec: Decisions, device, control: Optional[str] = None) -> np.ndarray:
    """Per greedy decision, the gap by which the chosen afterstate's value
    (oriented for the mover) lies below the best legal one's, by the f32
    reference with ``P[u]``, the params update u played with. ``control``
    ("fp8") takes the choice by fp8 values in place of the program's. NaN
    where the program's afterstate is not legal."""
    flat, flags, owner, at = _flat(dec)
    v = values_of(P, flat, flags, device, "f32", owner)
    vc = values_of(P, flat, flags, device, control, owner) if control else None
    out = []
    for i in range(len(dec.legal)):
        o = _orient(v[at[i]:at[i + 1]], dec.player[i])
        if control:
            j = int(np.argmax(_orient(vc[at[i]:at[i + 1]], dec.player[i])))
        else:
            j = _chosen(dec, i)
        out.append(float(o.max() - o[j]) if j >= 0 and len(o) else math.nan)
    return np.asarray(out, np.float64)


def twoply_scores(P: list, dec: Decisions, cand: List[List[int]], tw: dict, device,
                  workers: int, precisions=("f32",)) -> Tuple[Dict[str, list], float]:
    """The 2-ply score of the candidates ``cand[i]`` (indices into
    ``dec.legal[i]``) of each decision, for each precision: alpha V(c) -
    beta * sum over rolls of P(roll) * mean of the opponent's top-n reply
    values (oriented for the opponent), a roll without a reply adding 0.
    Also (reply rows, candidates): the legal replies the candidates have
    over the 21 rolls, the small doubles cut to their first ``cap`` as the
    algorithm defines, and how many candidates were scored."""
    jobs, where = [], []
    for i, cs in enumerate(cand):
        opp = 1 - dec.player[i]
        for c in cs:
            jobs.append((tuple(int(x) for x in dec.legal[i][c]), opp,
                         int(tw["small_double_cap"])))
            where.append((i, c))
    results = jobs_mod.pool_map("replies", jobs, workers)
    replies = [r for r, _ in results]
    sizes = [[len(r) for r in rr] for rr in replies]
    flat = np.concatenate([np.concatenate(rr) for rr in replies]) if replies else \
        np.zeros((0, N_CELLS), np.int8)
    # a reply is valued with the decision's mover on roll, and oriented for
    # the opponent
    flags = np.concatenate([np.full(sum(s), dec.player[i]) for (i, _), s in zip(where, sizes)]) \
        if where else np.zeros(0)
    owner = np.concatenate([np.full(sum(s), dec.rows[i][0]) for (i, _), s in zip(where, sizes)]) \
        if where else np.zeros(0)
    own_flat, own_flags, own_owner, own_at = _flat(dec)
    topn, alpha, beta = int(tw["top_n_responses"]), float(tw["alpha"]), float(tw["beta"])
    out = {}
    for prec in precisions:
        v_rep = values_of(P, flat, flags.astype(np.int64), device, prec, owner.astype(np.int64))
        v_own = values_of(P, own_flat, own_flags, device, prec, own_owner)
        scores = [np.full(len(cs), np.nan) for cs in cand]
        r0 = 0
        for (i, c), s in zip(where, sizes):
            opp = 1 - dec.player[i]
            e = 0.0
            for n, pr in zip(s, PROBS):
                if n:
                    top = np.sort(_orient(v_rep[r0:r0 + n], opp))[::-1][:topn]
                    e += pr * float(top.mean())
                r0 += n
            own = float(_orient(v_own[own_at[i] + c:own_at[i] + c + 1], dec.player[i])[0])
            scores[i][cand[i].index(c)] = alpha * own - beta * e
        out[prec] = scores
    return out, (float(sum(sum(x) for x in sizes)), float(len(sizes)))


def gaps_2ply(P: list, dec: Decisions, tw: dict, device, workers: int,
              control: Optional[str] = None) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Per greedy 2-ply decision (at least top-k legal moves), the gap by
    which the chosen afterstate's f32 2-ply score lies below the best among
    the choice itself and the reference's top-k by f32 value that lie more
    than ``TOPK_MARGIN`` above the next move's value (a candidate nearer the
    cut may fall on either side of it in a lower precision, and its score
    can differ by much). ``control`` ("fp8") makes the choice by the scorer
    in that precision in place of the program's. NaN where the program's
    afterstate is not legal. Also the reply rows and candidates scored
    (``twoply_scores``)."""
    k = int(tw["top_k_candidates"])
    flat, flags, owner, at = _flat(dec)
    precs = ("f32",) if control is None else ("f32", control)
    vals = {pr: values_of(P, flat, flags, device, pr, owner) for pr in precs}
    cand, chosen, ctrl_top, sure = [], [], [], []
    for i in range(len(dec.legal)):
        o = _orient(vals["f32"][at[i]:at[i + 1]], dec.player[i])
        order = [int(j) for j in np.argsort(-o, kind="stable")]
        cs = order[:k]
        cut = o[order[k]] if len(order) > k else -np.inf
        sure.append([j for j in cs if o[j] - cut > TOPK_MARGIN])
        ct = []
        j = _chosen(dec, i)
        if control:
            oc = _orient(vals[control][at[i]:at[i + 1]], dec.player[i])
            ct = [int(x) for x in np.argsort(-oc, kind="stable")[:k]]
            cs += [x for x in ct if x not in cs]
        elif j >= 0 and j not in cs:
            cs.append(j)
        cand.append(cs)
        chosen.append(j)
        ctrl_top.append(ct)
    sc, replies = twoply_scores(P, dec, cand, tw, device, workers, precs)
    out = []
    for i, cs in enumerate(cand):
        s32 = sc["f32"][i]
        if control:
            sctl = sc[control][i]
            j = max(ctrl_top[i], key=lambda c: sctl[cs.index(c)])
        else:
            j = chosen[i]
        if j < 0:
            out.append(math.nan)
            continue
        best = max(float(s32[cs.index(c)]) for c in sure[i] + [j])
        out.append(best - float(s32[cs.index(j)]))
    return np.asarray(out, np.float64), replies


def gaps_sampled(P: list, dec: Decisions, items: list, temps: List[float], tw: dict, device,
                 workers: int, control: Optional[str] = None) -> dict:
    """Per sampled decision, the gap by which the program's afterstate's
    sampled logit lies below the largest of its draw. ``items[i]`` is
    (kind, boards int8 [n, 52], noise f32 [n]): the afterstates the program
    drew among, in the order of the Gumbel noise it laid over them, and
    that noise; ``temps[i]`` the temperature of the decision's update by
    the configuration. Kind ``1ply``: every legal afterstate (checked
    against ``dec.legal``), logit the f32 value oriented for the mover over
    the temperature plus the noise; kind ``2ply``: the reranked candidates
    (each checked legal), logit the f32 2-ply score (``twoply_scores``)
    over the temperature plus the noise. ``control`` ("fp8") makes the
    draw by values or scores in that precision, with the same noise, in
    place of the program's. NaN where the draw's afterstates are not the
    legal ones or the program's afterstate is not among them. Returns
    {"1ply": gaps, "2ply": gaps, "replies": (reply rows, candidates),
    "notes": the first few failures described}."""
    out = {"1ply": [], "2ply": [], "replies": (0.0, 0.0), "notes": []}
    chosen = []
    for i, (kind, boards, _) in enumerate(items):
        keys = [x.tobytes() for x in boards]
        legal = {x.tobytes() for x in dec.legal[i]}
        a = dec.after[i]
        c = keys.index(a.tobytes()) if a is not None and a.tobytes() in keys else -1
        why = ""
        if kind == "1ply" and (len(keys) != len(legal) or set(keys) != legal):
            why = f"the draw's {len(keys)} afterstates are not the {len(legal)} legal ones"
        elif kind == "2ply" and not set(keys) <= legal:
            why = "a reranked candidate is not legal"
        elif c < 0:
            why = "the afterstate is not among the draw's"
        if why and len(out["notes"]) < 5:
            u, t, b = dec.rows[i]
            out["notes"].append(f"update {u + 1} step {t} game {b}: {why}")
        chosen.append(-1 if why else c)
    precs = ("f32",) if control is None else ("f32", control)
    one = [i for i, it in enumerate(items) if it[0] == "1ply"]
    two = [i for i, it in enumerate(items) if it[0] == "2ply"]
    logit_of: Dict[str, Dict[int, np.ndarray]] = {p: {} for p in precs}
    if one:
        flat = np.concatenate([items[i][1] for i in one]).reshape(-1, N_CELLS)
        flags = np.concatenate([np.full(len(items[i][1]), 1 - dec.player[i]) for i in one])
        owner = np.concatenate([np.full(len(items[i][1]), dec.rows[i][0]) for i in one])
        at = np.cumsum([0] + [len(items[i][1]) for i in one])
        for p in precs:
            v = values_of(P, flat, flags.astype(np.int64), device, p, owner.astype(np.int64))
            for j, i in enumerate(one):
                logit_of[p][i] = _orient(v[at[j]:at[j + 1]], dec.player[i]).astype(np.float64)
    if two:
        cd = _candidates_of(dec, two, items)
        sc, out["replies"] = twoply_scores(P, cd, [list(range(len(items[i][1]))) for i in two],
                                           tw, device, workers, precs)
        for p in precs:
            for j, i in enumerate(two):
                logit_of[p][i] = np.asarray(sc[p][j], np.float64)
    for i, (kind, _, noise) in enumerate(items):
        s32 = logit_of["f32"][i] / temps[i] + noise.astype(np.float64)
        if control:
            c = int(np.argmax(logit_of[control][i] / temps[i] + noise.astype(np.float64)))
        else:
            c = chosen[i]
        out[kind].append(float(s32.max() - s32[c]) if chosen[i] >= 0 else math.nan)
    out["1ply"] = np.asarray(out["1ply"], np.float64)
    out["2ply"] = np.asarray(out["2ply"], np.float64)
    return out


def _candidates_of(dec: Decisions, idx: List[int], items: list) -> Decisions:
    """Decisions ``idx`` of ``dec`` whose move lists are the program's
    reranked candidates (``items[i][1]``), for ``twoply_scores``."""
    s = Decisions.__new__(Decisions)
    s.rows = [dec.rows[i] for i in idx]
    s.board = [dec.board[i] for i in idx]
    s.player = [dec.player[i] for i in idx]
    s.dice = [dec.dice[i] for i in idx]
    s.after = [dec.after[i] for i in idx]
    s.legal = [np.asarray(items[i][1], np.int8).reshape(-1, N_CELLS) for i in idx]
    return s


def enumerate_legal(dec: Decisions, workers: int) -> None:
    """Fill ``dec.legal`` with each decision's legal afterstates."""
    jobs = [(tuple(int(x) for x in bd), p, d[0], d[1])
            for bd, p, d in zip(dec.board, dec.player, dec.dice)]
    dec.legal = jobs_mod.pool_map("legal", jobs, workers)
