"""Small cells for the CPU tests: the production configurations at a few
games and steps, and a short reference sample."""
import time

import torch

OVERRIDES = {
    "prod1ply.train": {"config": {"batch_games": 32, "steps_per_update": 4},
                       "traffic": {"legality_decisions": 80, "greedy_decisions": 80, "settle_s": 0,
                                   "greedy_share": 0.25, "oracle_workers": 1,
                                   "resampled_steps": 4, "sampled_decisions": 60}},
    "prod2ply.train": {"config": {"batch_games": 16, "steps_per_update": 4},
                       "traffic": {"legality_decisions": 40, "greedy_decisions": 40, "settle_s": 0,
                                   "twoply_decisions": 4, "greedy_share": 0.25,
                                   "oracle_workers": 1, "resampled_steps": 4,
                                   "sampled_decisions": 30}},
}


# the 1-ply cell with games past their openings in the replayed steps and
# some hundreds of sampled decisions, where a wrong temperature shows
MID_1PLY = {"config": {"batch_games": 64, "steps_per_update": 16},
            "traffic": {**OVERRIDES["prod1ply.train"]["traffic"], "greedy_share": 0.125,
                        "resampled_steps": 16, "sampled_decisions": 600}}


def run_small(workload: str, seed: int = 20241017, seconds: float = 0.5, trace: bool = False,
              root=None, overrides=None):
    from benchmark import harness

    torch.set_num_threads(2)
    kw = {} if root is None else {"root": root}
    return harness.run(workload, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                       workers=1, overrides=overrides or OVERRIDES[workload], **kw)
