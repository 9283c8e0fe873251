"""The port's 2-ply step against the JAX package on the production
numerics: candidate and reply values through the fused board -> value op in
bf16 (JAX's Pallas kernel in interpret mode, the port's plain version on the
CPU), td_mode "side0", per-roll non-doubles reply widths, and a batch above
64 games so that the merged legal moves run the doubles sub-batch.

The harness is test_torch_twoply.py's. Tolerances: legal moves, transitions
and next state bit-exact on agreeing rows; E[opponent response] within 5e-3
(the bf16 tolerance of test_torch_value.py: each reply value is within it,
and the response is a probability-weighted mean of them); decisions agree on
every row but near-ties of the sampled logits.
"""
import numpy as np
import pytest

import tests.test_torch_twoply as base
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

BF16_TOL = 5e-3
B = 72
STEPS = 3


@pytest.fixture(scope="module")
def bf16_run():
    return base.teacher_forced(
        "side0", True, 23, B, STEPS, nd_reply_widths=(24,) * 10 + (32,) * 5
    )


def test_merged_legal_moves_with_doubles_sub_batch(bf16_run):
    for i, s in enumerate(bf16_run):
        jm, tm = s["jmoves"], s["tmoves"]
        for f in ("valid", "count", "overflow"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jm, f)), getattr(tm, f).numpy(), err_msg=f"step {i} {f}"
            )
        m = np.asarray(jm.valid)
        np.testing.assert_array_equal(np.asarray(jm.boards.data)[m], tm.boards.data.numpy()[m])


def test_weighted_opponent_response_bf16(bf16_run):
    worst = max(float(np.abs(s["tw_o"] - s["jw_o"]).max()) for s in bf16_run)
    print(f"bf16: max |dE| = {worst:.3e}")
    assert worst <= BF16_TOL


def test_rollout_step_2ply_teacher_forced_bf16(bf16_run):
    n_dis = 0
    for i, s in enumerate(bf16_run):
        rows = np.nonzero(s["jaction"] != s["taction"])[0]
        n_dis += len(rows)
        gaps = base.near_tie_rows(s, rows)
        assert all(g < 2 * BF16_TOL / base.TEMP for g in gaps), gaps
        agree = s["jaction"] == s["taction"]
        lw, lg = base.leaves(s["jt"]), base.leaves(s["tt"])
        for k in lw:
            if k == "value":
                assert np.abs(lw[k] - lg[k]).max() <= BF16_TOL
            else:
                np.testing.assert_array_equal(lw[k][agree], lg[k][agree], err_msg=f"{i} {k}")
        ln, lt = base.leaves(s["jnew"]), base.leaves(s["tnew"])
        for k in ln:
            np.testing.assert_array_equal(ln[k][agree], lt[k][agree], err_msg=f"{i} {k}")
    print(f"bf16: {n_dis} disagreements in {B * STEPS} decisions")
