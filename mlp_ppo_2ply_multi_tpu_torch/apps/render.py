"""Terminal board renderer.

Same capability as the reference's ASCII renderer
(the reference repository's src/play/game_renderer.py:6-130): a two-half board with
point numbers, stacked checker tokens (X = player 1, O = player 2), and bar /
borne-off columns. Layout is this repo's own design.
"""
from __future__ import annotations

from typing import List

from mlp_ppo_2ply_multi_tpu_torch.oracle.rules import BoardT

TOKENS = ("X", "O")  # player 0, player 1


def _stack_char(board: BoardT, point: int, row: int) -> str:
    for pl in (0, 1):
        n = board[pl][point]
        if n > row:
            return TOKENS[pl] if row < 5 or n <= 6 else str(n)
    return " "


def render(board: BoardT, to_move: int, dice=None) -> str:
    """Render a board tuple as a multi-line string. Points 12..23 on top
    (left->right), 11..0 on the bottom, matching the standard clockwise view
    for player 0 moving 0->23."""
    lines: List[str] = []
    top = list(range(12, 24))
    bottom = list(range(11, -1, -1))

    def fmt_row(points, row, reverse=False):
        r = row if not reverse else row
        cells = [f" {_stack_char(board, p, r)} " for p in points]
        left = cells[:6]
        right = cells[6:]
        return "|" + "".join(left) + "|BAR|" + "".join(right) + "|"

    lines.append("+" + "-" * 18 + "+---+" + "-" * 18 + "+")
    lines.append(
        "|" + "".join(f"{p+1:2d} " for p in top[:6]) + "|   |"
        + "".join(f"{p+1:2d} " for p in top[6:]) + "|"
    )
    for row in range(5):
        lines.append(fmt_row(top, row))
    bar_line = f"  bar: X={board[2][0]} O={board[2][1]}   off: X={board[3][0]} O={board[3][1]}"
    lines.append("|" + " " * 18 + "|BAR|" + " " * 18 + "|" + bar_line)
    for row in range(4, -1, -1):
        lines.append(fmt_row(bottom, row))
    lines.append(
        "|" + "".join(f"{p+1:2d} " for p in bottom[:6]) + "|   |"
        + "".join(f"{p+1:2d} " for p in bottom[6:]) + "|"
    )
    lines.append("+" + "-" * 18 + "+---+" + "-" * 18 + "+")
    mover = TOKENS[to_move]
    tail = f"to move: {mover}"
    if dice is not None:
        tail += f"   dice: {int(dice[0])},{int(dice[1])}"
    lines.append(tail)
    return "\n".join(lines)


def describe_move(submoves) -> str:
    """Human-readable full move, e.g. '24/20 13/9' (1-indexed points; bar/off
    named)."""
    parts = []
    for s, e, hits in submoves:
        a = "bar" if s == 24 else str(s + 1)
        b = "off" if e == 25 else str(e + 1)
        parts.append(f"{a}/{b}{'*' if hits else ''}")
    return " ".join(parts) if parts else "(pass)"
