"""The frozen copies of the kernels' bounds and the peaks equal the
program's functions today on shared inputs."""
import pytest
import torch

from benchmark import yardstick as Y


def test_peaks_are_the_programs():
    from mlp_ppo_2ply_multi_tpu_torch.utils import cost

    assert (Y.BF16_FLOP_PER_S, Y.HBM_BYTES_PER_S, Y.CORE_OPS_PER_S) == (
        cost.BF16_FLOP_PER_S, cost.HBM_BYTES_PER_S, cost.CORE_OPS_PER_S)


@pytest.mark.parametrize("K", [96, 288, 576])
def test_nd_tail_bound_is_the_programs(K):
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    g = torch.Generator().manual_seed(K)
    valid = torch.rand((64, Y.N_CAND), generator=g) < torch.rand((64, 1), generator=g) * 0.2
    mine, prog = Y.nd_tail_bound(valid, K), nd_tail.bound(valid, K)
    for k in ("rows", "bytes", "ops", "bound_ms", "bound_by"):
        assert mine[k] == prog[k], k
    assert torch.equal(Y.nd_tail_child_rows(valid, K), nd_tail.child_rows(valid, K))


def test_fused_value_bound_is_the_programs_on_legal_rows():
    from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value

    g = torch.Generator().manual_seed(3)
    boards = torch.randint(0, 5, (500, 52), generator=g, dtype=torch.int8)
    prog = fused_value.bound(boards)
    c = boards.to(torch.int32)
    nnz = float(c[:, :48].clamp(0, 4).sum() + (c[:, 48:] > 0).sum()) / 500
    mine = Y.fused_value_bound(500, nnz, launches=1)
    for k in ("bytes", "ops", "bound_ms"):
        assert mine[k] == pytest.approx(prog[k], rel=1e-12), k
    assert mine["bound_by"] == prog["bound_by"]
