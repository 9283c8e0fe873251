"""Core enums and constants for the TPU-native backgammon framework.

Mirrors the public type surface of the reference implementation
(reference src/backgammon/types/moves.py:7-65) but as plain ints /
IntEnums suitable for use as static constants inside jitted code.
"""
from __future__ import annotations

import enum

NUM_POINTS = 24

# Pseudo-point indices used in submove encodings (reference moves.py:32-33).
BAR = 24
BEAR_OFF = 25
# Sentinel "no submove" slot used in fixed-shape move tables (no reference
# analog; padding for XLA static shapes).
NO_MOVE = 26

CHECKERS_PER_PLAYER = 15


class Player(enum.IntEnum):
    """Player ids, identical values to reference moves.py:36-42."""

    P1 = 0
    P2 = 1


def opponent(player: int) -> int:
    """reference conditions.py:197-198."""
    return 1 - player


class BoardStateKind(enum.IntEnum):
    """Turn-state dispatch, reference moves.py:58-62 (BoardState enum).

    Integer codes chosen so they can live in int8 arrays inside jit.
    """

    NORMAL = 0
    ON_BAR = 1
    BEAR_OFF = 2
    GAME_OVER = 3


class WinType(enum.IntEnum):
    """Win classification, reference backgammon_env.py:167-190."""

    NONE = 0
    REGULAR = 1
    GAMMON = 2
    BACKGAMMON = 3


# Home board point ranges per player (reference conditions.py:170-173).
HOME_RANGE = ((18, 24), (0, 6))

# Per-player movement direction (reference get_moves_one_die.py:55).
DIRECTION = (1, -1)

FEATURE_DIM = 198
