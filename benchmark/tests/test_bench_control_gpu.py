"""The control, kept as a test at a size a test run holds: on the card, the
reference put in the program's place one precision down (TF32 learner,
fp8 values) comes out not correct on three seeds, and the sound program
correct. The cell's own size is ``python3 -m benchmark.control``."""
import pytest
import torch

SMALL = {"config": {"batch_games": 512, "steps_per_update": 8},
         "traffic": {"legality_decisions": 200, "greedy_decisions": 400, "twoply_decisions": 16,
                     "settle_s": 0}}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["prod1ply.train", "prod2ply.train"])
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 and the program's kernels need a CUDA card")
    from benchmark import control

    lines = control.readings(workload, [7001, 7002, 7003], 3, [], 0, torch.device("cuda", 0),
                             emit=lambda s: None, overrides=SMALL)
    sound = [x for x in lines if x["reading"] == "sound"]
    ctl = [x for x in lines if x["reading"] == "control"]
    assert len(sound) == 3 and all(x["correct"] for x in sound), sound
    assert len(ctl) == 3 and not any(x["correct"] for x in ctl), ctl
