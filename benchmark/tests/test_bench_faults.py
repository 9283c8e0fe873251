"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU
with each fault a one-card training cell can have planted (``faults.py``;
it has no exchange between chips), and with each fault of the sampler
(a wrong temperature, noise laid over another game's moves)."""
import pytest

from benchmark.faults import FAULTS, planted
from benchmark.tests.small import MID_1PLY, run_small


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    with planted(fault):
        out = run_small("prod1ply.train", overrides=MID_1PLY)
    failed = [n for n, v, lim in out["compared"] if not v <= lim]
    assert not out["correct"] and failed, out["compared"]


def test_unknown_fault_refused():
    with pytest.raises(ValueError):
        with planted("nothing"):
            pass


def test_twoply_sampler_fault_is_not_correct():
    with planted("noise_row"):
        out = run_small("prod2ply.train")
    failed = [n for n, v, lim in out["compared"] if not v <= lim]
    assert not out["correct"] and "sampled_twoply_gap" in failed, out["compared"]
