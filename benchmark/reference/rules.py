"""Backgammon rules in plain Python: the benchmark's frozen reference.

A copy of the port's rules oracle (``oracle/rules.py``), kept here so that no
change to the program can move the yardstick, plus what the reference needs
beyond the oracle: the doubles afterstates in the canonical order that the
port's "first 50 replies" cap of the 2-ply scorer counts in
(``doubles_canonical``), and conversions from the 52-cell board rows the
program stores. It imports nothing of the program.

The reference ships no tests (SURVEY.md §4), so correctness of the vectorized
TPU engine is established against this small, readable oracle instead. It is a
clean-room reimplementation of the reference's *behavior* — including its
quirks (SURVEY.md §7.1 Q5-Q11) — with citations to the reference for every
rule, but organized differently (flat tuples, no classes per concept).

Board representation: a plain tuple
    (points_p1, points_p2, bar, off)
where points_* are 24-tuples of ints, bar and off are 2-tuples.

Submoves are (start, end, hits) int triples with start in 0..23 or 24 (bar)
and end in 0..23 or 25 (bear-off) — same encoding as the engine's slot table.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

BAR = 24
OFF = 25

BoardT = Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, int], Tuple[int, int]]
SubMoveT = Tuple[int, int, bool]


def start_board() -> BoardT:
    """Opening position, reference immutable_board.py:27-70."""
    p1 = [0] * 24
    p2 = [0] * 24
    p1[0], p1[11], p1[16], p1[18] = 2, 5, 3, 5
    p2[23], p2[12], p2[7], p2[5] = 2, 5, 3, 5
    return (tuple(p1), tuple(p2), (0, 0), (0, 0))


def own(board: BoardT, player: int) -> Tuple[int, ...]:
    return board[player]


def opp(board: BoardT, player: int) -> Tuple[int, ...]:
    return board[1 - player]


def apply_submove(board: BoardT, player: int, mv: SubMoveT) -> BoardT:
    """reference env_helper.py:27-91 semantics (unchecked application)."""
    start, end, hits = mv
    pts = [list(board[0]), list(board[1])]
    bar = list(board[2])
    off = list(board[3])
    if start == BAR:
        bar[player] -= 1
    else:
        pts[player][start] -= 1
    if hits:
        pts[1 - player][end] -= 1
        bar[1 - player] += 1
    if end == OFF:
        off[player] += 1
    else:
        pts[player][end] += 1
    return (tuple(pts[0]), tuple(pts[1]), tuple(bar), tuple(off))


def apply_fullmove(board: BoardT, player: int, moves: Sequence[SubMoveT]) -> BoardT:
    for mv in moves:
        board = apply_submove(board, player, mv)
    return board


# --------------------------------------------------------------------------
# State predicates
# --------------------------------------------------------------------------

def home_range(player: int) -> range:
    """reference conditions.py:170-173."""
    return range(18, 24) if player == 0 else range(0, 6)


def won(board: BoardT, player: int) -> bool:
    return board[3][player] == 15  # conditions.py:137-149


def all_home(board: BoardT, player: int) -> bool:
    """conditions.py:152-194."""
    if board[2][player] > 0:
        return False
    hr = home_range(player)
    return all(c == 0 or i in hr for i, c in enumerate(own(board, player)))


def state_kind(board: BoardT, player: int) -> str:
    """conditions.py:5-22 dispatch priority."""
    if won(board, player):
        return "over"
    if board[2][player] > 0:
        return "bar"
    if all_home(board, player):
        return "bearoff"
    return "normal"


def gammon(board: BoardT, winner: int) -> bool:
    return board[3][1 - winner] == 0  # env_helper.py:120-127


def backgammon(board: BoardT, winner: int) -> bool:
    """env_helper.py:130-163."""
    if board[3][1 - winner] > 0:
        return False
    loser_pts = opp(board, winner)
    in_home = any(loser_pts[i] > 0 for i in home_range(winner))
    return in_home or board[2][1 - winner] > 0


def closed_out(board: BoardT, player: int) -> bool:
    """env_helper.py:218-242."""
    if board[2][1 - player] == 0:
        return False
    pts = own(board, player)
    return all(pts[i] >= 2 for i in home_range(player))


def five_prime(board: BoardT, player: int) -> bool:
    """env_helper.py:167-215 — scan in the player's travel direction keeping a
    running made-point streak; on any streak >= 5 check for trapped opponent
    checkers behind the prime."""
    pts = own(board, player)
    other = opp(board, player)
    order = range(24) if player == 0 else range(23, -1, -1)
    streak = 0
    for i in order:
        streak = streak + 1 if pts[i] >= 2 else 0
        if streak >= 5:
            if player == 0:
                behind = range(i + 1, 24)
            else:
                behind = range(0, i)
            if any(other[j] > 0 for j in behind):
                return True
    return False


# --------------------------------------------------------------------------
# Single-die move generation (reference get_moves_one_die.py)
# --------------------------------------------------------------------------

def _blocked(board: BoardT, player: int, dest: int) -> bool:
    return opp(board, player)[dest] >= 2  # conditions.py:25-62


def _blot(board: BoardT, player: int, dest: int) -> bool:
    return opp(board, player)[dest] == 1  # conditions.py:65-89


def one_die_moves(board: BoardT, player: int, die: int) -> List[SubMoveT]:
    """All submoves for one die, in reference enumeration order
    (get_moves_one_die.py:13-251)."""
    kind = state_kind(board, player)
    if kind == "over":
        return []
    sign = 1 if player == 0 else -1
    pts = own(board, player)

    if kind == "bar":
        e = die - 1 if player == 0 else 24 - die
        if not _blocked(board, player, e):
            return [(BAR, e, _blot(board, player, e))]
        return []

    if kind == "normal":
        out: List[SubMoveT] = []
        for i in range(24):
            if pts[i] <= 0:
                continue
            d = i + die * sign
            if 0 <= d < 24 and not _blocked(board, player, d):
                out.append((i, d, _blot(board, player, d)))
        return out

    # bear-off state, get_moves_one_die.py:133-251
    out = []
    hr = list(home_range(player))
    for i in hr:
        if pts[i] <= 0:
            continue
        d = i + die * sign
        if 0 <= d < 24 and not _blocked(board, player, d):
            out.append((i, d, _blot(board, player, d)))
    # farthest occupied home point from the exit
    if player == 0:
        last = next((i for i in hr if pts[i] > 0), 18)
        if last + die >= 24:
            out.append((last, OFF, False))
        exact = 24 - die
    else:
        last = next((i for i in reversed(hr) if pts[i] > 0), 5)
        if last - die < 0:
            out.append((last, OFF, False))
        exact = die - 1
    if exact != last and pts[exact] > 0:
        out.append((exact, OFF, False))
    return out


# --------------------------------------------------------------------------
# Full-move enumeration (reference generate_all_moves.py /
# handle_move_types.py) — returns (moves, boards) where boards[i] is the
# afterstate of moves[i], in reference insertion order after dedup and the
# max-submove filter.
# --------------------------------------------------------------------------

def _pass_pairs(
    board: BoardT, player: int, d_first: int, d_second: int
) -> Tuple[List[Tuple[Tuple[SubMoveT, ...], BoardT]], List[Tuple[Tuple[SubMoveT, ...], BoardT]]]:
    """One non-doubles pass (handle_move_types.py:7-81): all 2-submove
    sequences (first die then second), plus the 1-submove fallbacks used only
    if the pass produced no pairs."""
    pairs: List[Tuple[Tuple[SubMoveT, ...], BoardT]] = []
    singles: List[Tuple[Tuple[SubMoveT, ...], BoardT]] = []
    firsts = one_die_moves(board, player, d_first)
    for m1 in firsts:
        b1 = apply_submove(board, player, m1)
        for m2 in one_die_moves(b1, player, d_second):
            pairs.append(((m1, m2), apply_submove(b1, player, m2)))
    if not pairs:
        for m1 in firsts:
            singles.append(((m1,), apply_submove(board, player, m1)))
    return pairs, singles


def full_moves(
    board: BoardT, player: int, roll: Sequence[int]
) -> List[Tuple[Tuple[SubMoveT, ...], BoardT]]:
    """reference generate_all_moves.py:7-66 + handle_move_types.py."""
    seen: Dict[BoardT, None] = {}
    out: List[Tuple[Tuple[SubMoveT, ...], BoardT]] = []

    def add(moves: Tuple[SubMoveT, ...], b: BoardT) -> None:
        if b not in seen:  # add_unique_board, handle_move_types.py:196-221
            seen[b] = None
            out.append((moves, b))

    d0, d1 = roll
    if d0 != d1:
        hi, lo = max(d0, d1), min(d0, d1)
        pairs_a, singles_a = _pass_pairs(board, player, hi, lo)
        for mv, b in pairs_a + singles_a:
            add(mv, b)
        # reverse-order pass is skipped only when pass A yielded exactly one
        # (unique) move and it used a single die (generate_all_moves.py:40-50)
        skip_b = len(out) == 1 and len(out[0][0]) == 1
        if not skip_b:
            pairs_b, singles_b = _pass_pairs(board, player, lo, hi)
            for mv, b in pairs_b + singles_b:
                add(mv, b)
    else:
        _doubles(board, player, d0, add)

    if not out:
        return []
    # must-use-max-dice filter, generate_all_moves.py:69-90
    mx = max(len(mv) for mv, _ in out)
    return [(mv, b) for mv, b in out if len(mv) == mx]


def _doubles(board: BoardT, player: int, die: int, add) -> None:
    """Depth-4 DFS for doubles (handle_move_types.py:84-193) with the
    reference's exact shorter-sequence rules: a length-k sequence (k<4) is
    recorded only when it cannot be extended, its final submove was the *only*
    option at that depth, and no 4-long sequence has been recorded yet."""
    state = {"latch": False}  # full_move_of_length_4_possible

    def recurse(b: BoardT, prefix: Tuple[SubMoveT, ...]) -> None:
        depth = len(prefix)
        moves = one_die_moves(b, player, die)
        for mv in moves:
            nb = apply_submove(b, player, mv)
            seq = prefix + (mv,)
            if depth == 3:
                add(seq, nb)
                state["latch"] = True
            else:
                nxt = one_die_moves(nb, player, die)
                if not nxt and len(moves) == 1 and not state["latch"]:
                    add(seq, nb)
                if nxt or depth < 3:
                    recurse(nb, seq)

    recurse(board, ())


# --------------------------------------------------------------------------
# 198-feature encoding (reference immutable_board.py:86-128, layout Q11)
# --------------------------------------------------------------------------

def encode(board: BoardT, player: int) -> List[float]:
    feats: List[float] = []
    for pts in (board[0], board[1]):
        for c in pts:
            feats += [
                1.0 if c >= 1 else 0.0,
                1.0 if c >= 2 else 0.0,
                1.0 if c >= 3 else 0.0,
                max(c - 3, 0) / 2.0,
            ]
    feats += [
        board[2][0] / 2.0,
        board[3][0] / 15.0,
        board[2][1] / 2.0,
        board[3][1] / 15.0,
        1.0 if player == 0 else 0.0,
        1.0 if player == 1 else 0.0,
    ]
    assert len(feats) == 198
    return feats


# --------------------------------------------------------------------------
# The canonical doubles order and the 52-cell rows
# --------------------------------------------------------------------------

def board_from_cells(cells) -> BoardT:
    """A 52-cell row (p0 points 0..23, p1 points 0..23, bar p0, bar p1,
    off p0, off p1) as a board tuple."""
    c = [int(x) for x in cells]
    return (tuple(c[0:24]), tuple(c[24:48]), (c[48], c[49]), (c[50], c[51]))


def cells(board: BoardT) -> Tuple[int, ...]:
    """The 52-cell row of a board tuple."""
    return tuple(board[0]) + tuple(board[1]) + tuple(board[2]) + tuple(board[3])


def _rank(player: int, mv: SubMoveT) -> int:
    """Canonical rank of a submove: the start point counted in the player's
    direction of travel, doubled, plus one for a bear-off; a bar entry -1."""
    start, end, _ = mv
    if start == BAR:
        return -1
    adj = start if player == 0 else 23 - start
    return 2 * adj + (1 if end == OFF else 0)


def doubles_canonical(board: BoardT, player: int, die: int) -> List[BoardT]:
    """The legal afterstates of a double in canonical order: each multiset
    of submoves once, as the sequence whose ranks do not decrease, expanded
    level by level with the parents in order and each parent's submoves in
    ``one_die_moves`` order; the full-length level when one exists, else the
    longest forced-short level (a sequence that cannot go on and whose last
    submove was its board's only one). The same set as ``full_moves``."""
    levels: List[List[Tuple[BoardT, int, bool]]] = []
    front = [(board, -2, False)]  # (board, rank of the last submove, only)
    shorts: List[List[BoardT]] = []
    for _ in range(4):
        nxt: List[Tuple[BoardT, int, bool]] = []
        short: List[BoardT] = []
        for b, last, only in front:
            mvs = one_die_moves(b, player, die)
            if levels and only and not mvs:
                short.append(b)
            for mv in mvs:
                r = _rank(player, mv)
                if levels and r < last:
                    continue
                nxt.append((apply_submove(b, player, mv), r, len(mvs) == 1))
        if levels:
            shorts.append(short)
        levels.append(nxt)
        front = nxt
    if levels[3]:
        return [b for b, _, _ in levels[3]]
    for short in reversed(shorts):
        if short:
            return short
    return []
