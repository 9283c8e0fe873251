"""Pure-python environment oracle with injectable dice.

Replicates the reference gym env's semantics
(the reference repository's src/environments/backgammon_env.py) — including quirks Q5
(nonstandard opening), Q7 (500-move truncation in enumeration order), Q8
(invalid action penalty), Q10 (rewards and one-time shaping) — but driven by
an explicit dice iterator so transcripts are reproducible. Used only in tests
and as the slow single-game backend for the play CLI.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional, Tuple

from mlp_ppo_2ply_multi_tpu_torch.oracle import rules

REWARD_PASS = 0.0
REWARD_INVALID = -1.0
REWARD_WIN = 1.0
REWARD_GAMMON = 2.0
REWARD_BACKGAMMON = 2.5
REWARD_CLOSE_OUT = 0.30
REWARD_PRIME = 0.20


class OracleEnv:
    def __init__(
        self,
        dice: Iterable[Tuple[int, int]],
        max_legal_moves: int = 500,
        shaping: bool = True,
    ):
        self._dice: Iterator[Tuple[int, int]] = iter(dice)
        self.max_legal_moves = max_legal_moves
        self.shaping = shaping
        self.board = rules.start_board()
        self.player = 0
        self.roll: Tuple[int, int] = (0, 0)
        self.game_over = False
        self.win_type: Optional[str] = None
        self.legal: List[Tuple[Tuple[rules.SubMoveT, ...], rules.BoardT]] = []
        self._close_out_given = [False, False]
        self._prime_given = [False, False]

    # -- dice ---------------------------------------------------------------
    def _next_roll(self) -> Tuple[int, int]:
        return next(self._dice)

    # -- API mirroring the reference env ------------------------------------
    def reset(self):
        """Opening procedure, reference backgammon_env.py:92-128 (Q5): a
        non-doubles roll decides the starter, then a *fresh* non-doubles roll
        is used for the first move."""
        self.board = rules.start_board()
        self.game_over = False
        self.win_type = None
        r = self._next_roll()
        while r[0] == r[1]:
            r = self._next_roll()
        self.player = 1 if r[0] < r[1] else 0
        r = self._next_roll()
        while r[0] == r[1]:
            r = self._next_roll()
        self.roll = r
        self._update_legal()
        self._close_out_given = [False, False]
        self._prime_given = [False, False]
        return self.observation()

    def observation(self) -> List[float]:
        return rules.encode(self.board, self.player)

    @property
    def num_moves(self) -> int:
        return len(self.legal)

    def _update_legal(self) -> None:
        moves = rules.full_moves(self.board, self.player, list(self.roll))
        self.legal = moves[: self.max_legal_moves]  # Q7 truncation

    def step(self, action: Optional[int]):
        info = {"current_player": self.player}
        if self.game_over:
            return self.observation(), 0.0, True, info

        if self.num_moves == 0:
            # auto-pass, backgammon_env.py:139-151
            self.player = 1 - self.player
            self.roll = self._next_roll()
            self._update_legal()
            return self.observation(), REWARD_PASS, False, {**info, "info": "pass"}

        if action is None or not (0 <= action < self.num_moves):
            # Q8: penalty, state unchanged (backgammon_env.py:153-158)
            return self.observation(), REWARD_INVALID, False, {**info, "info": "invalid"}

        _, after = self.legal[action]
        self.board = after
        reward = 0.0

        if self.board[3][self.player] >= 15:  # env_helper.py:113-117
            if rules.backgammon(self.board, self.player):
                reward, self.win_type = REWARD_BACKGAMMON, "backgammon"
            elif rules.gammon(self.board, self.player):
                reward, self.win_type = REWARD_GAMMON, "gammon"
            else:
                reward, self.win_type = REWARD_WIN, "regular"
            info.update({"winner": self.player, "win_type": self.win_type})
            self.game_over = True
            return self.observation(), reward, True, info

        if self.shaping:
            if rules.closed_out(self.board, self.player) and not self._close_out_given[
                self.player
            ]:
                reward += REWARD_CLOSE_OUT
                self._close_out_given[self.player] = True
                info["close_out_reward"] = True
            if rules.five_prime(self.board, self.player) and not self._prime_given[
                self.player
            ]:
                reward += REWARD_PRIME
                self._prime_given[self.player] = True
                info["prime_reward"] = True

        self.player = 1 - self.player
        self.roll = self._next_roll()
        self._update_legal()
        return self.observation(), reward, False, info


def play_transcript(
    dice: Iterable[Tuple[int, int]],
    policy: Callable[["OracleEnv"], Optional[int]],
    max_steps: int = 300,
):
    """Run one episode; returns a transcript list of
    (player, roll, num_moves, action, reward, done, board_after)."""
    env = OracleEnv(dice)
    env.reset()
    out = []
    steps = 0
    done = False
    while not done and steps < max_steps:
        player, roll, n = env.player, env.roll, env.num_moves
        action = None if n == 0 else policy(env)
        _, reward, done, _ = env.step(action)
        out.append((player, roll, n, action, reward, done, env.board))
        steps += 1
    return out, env
