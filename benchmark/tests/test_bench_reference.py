"""The plain reference agrees with the program on the CPU at small sizes:
the canonical doubles order the 2-ply cap counts in, and whole runs of both
cells (set-up, window, every number ``correct`` compares)."""
import numpy as np
import pytest
import torch

from benchmark.reference import rules
from benchmark.tests.small import run_small


def test_doubles_canonical_order_is_the_programs():
    from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
    from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
    from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases

    torch.set_num_threads(2)
    boards, players, dice = sample_cases(4242, 96, doubles_bias=1.0)
    data = torch.tensor(np.array([rules.cells(b) for b in boards], np.int8))
    ms = movegen2.legal_moves(Board(data), torch.tensor(players).int(), torch.tensor(dice).int(),
                              MoveGenConfig(algo="canonical", dd_subbatch_div=0))
    checked = 0
    for g in range(len(boards)):
        if dice[g][0] != dice[g][1] or bool(ms.overflow[g]):
            continue
        prog = [bytes(x) for x in ms.boards.data[g][ms.valid[g]].numpy().astype(np.int8)]
        ref = rules.doubles_canonical(boards[g], int(players[g]), int(dice[g][0]))
        assert [bytes(np.array(rules.cells(b), np.int8)) for b in ref] == prog
        assert set(ref) == {b for _, b in rules.full_moves(boards[g], int(players[g]), dice[g])}
        checked += 1
    assert checked >= 80


@pytest.mark.parametrize("workload", ["prod1ply.train", "prod2ply.train"])
def test_reference_agrees_with_the_program(workload):
    out = run_small(workload)
    nums = {n: v for n, v, _ in out["compared"]}
    assert out["correct"], out["compared"]
    assert nums["env_mismatch"] == 0 and nums["rules_mismatch"] == 0
    assert nums["loss_gap"] < 1e-4 and nums["step_gap"] < 1e-2
    assert out["updates"] >= 1
    assert set(out["metrics"]) == {"env_steps_per_s", "update_ms_p90", "peak_mem_gib", "setup_s"}


def test_worker_processes_give_the_in_process_results():
    from benchmark.reference import jobs
    from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases

    boards, players, dice = sample_cases(77, 24, doubles_bias=0.3)
    work = [(rules.cells(b), int(p), int(d[0]), int(d[1])) for b, p, d in zip(boards, players, dice)]
    here, there = jobs.run_jobs("legal", work), jobs.pool_map("legal", work, 3)
    assert len(there) == len(here) and all(np.array_equal(a, b) for a, b in zip(here, there))
