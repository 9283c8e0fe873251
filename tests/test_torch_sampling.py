"""The port's copy of the random-position sampler against the JAX package's:
``random_board`` in every mode, ``random_roll`` at every doubles bias and
``sample_cases`` (the contract of ``tests/helpers.py``) give identical
boards, players and dice from one seed, and leave the generator in the same
state."""
import random

import pytest

from mlp_ppo_2ply_multi_tpu.oracle import sampling as jsampling
from mlp_ppo_2ply_multi_tpu_torch.oracle import sampling
from tests import helpers

MODES = ["mixed", "open", "race", "bar", "dense", "endgame"]
BIASES = [0.0, 0.2, 0.35, 0.4, 1.0]


@pytest.mark.parametrize("mode", MODES)
def test_random_board_equals_jax(mode):
    for seed in range(3):
        a, b = random.Random(seed), random.Random(seed)
        got = [sampling.random_board(a, mode) for _ in range(200)]
        want = [jsampling.random_board(b, mode) for _ in range(200)]
        assert got == want
        assert a.getstate() == b.getstate()
    for board in got:
        assert sum(board[0]) + board[2][0] + board[3][0] == 15
        assert sum(board[1]) + board[2][1] + board[3][1] == 15
        assert not any(x and y for x, y in zip(board[0], board[1]))


@pytest.mark.parametrize("bias", BIASES)
def test_random_roll_equals_jax(bias):
    a, b = random.Random(11), random.Random(11)
    got = [sampling.random_roll(a, doubles_bias=bias) for _ in range(2000)]
    assert got == [jsampling.random_roll(b, doubles_bias=bias) for _ in range(2000)]
    assert all(1 <= d <= 6 for roll in got for d in roll)


@pytest.mark.parametrize("bias", BIASES)
def test_sample_cases_equals_the_tests_helper(bias):
    """The stress's batches: seeds 50_000.. at 128 positions."""
    for seed in (50_000, 50_001, 7):
        got = sampling.sample_cases(seed, 128, doubles_bias=bias)
        assert got == helpers.sample_cases(seed, 128, doubles_bias=bias)
    assert sampling.sample_cases(3, 16) == helpers.sample_cases(3, 16)  # default bias 0.4
