"""The port's CUDA kernel on the card against its plain PyTorch version.

These tests need a CUDA card and skip elsewhere (the kernel has no CPU
mode). The file imports torch and the port only, so on the card it runs
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py
"""
import pathlib
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv

CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
# same rounding points; an f32 summation order can move one hidden unit by
# one bf16 ulp (<= 2^-9), times |w2|
TOL = 5e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 96), (256, 448), (3, 5)])
def test_fused_value_kernel_matches_plain(shape):
    """Tier-1 and tier-2 main-path shapes, and a ragged tiny one."""
    dev = _card()
    params = value_net.load_checkpoint(CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    boards = torch.randint(0, 16, (*shape, 52), generator=gen, device=dev).to(torch.int8)
    flag = torch.randint(0, 2, (shape[0], 1), generator=gen, device=dev)
    before = fv.KERNEL.launches
    got = fv.fused_value(boards, flag, params)
    assert fv.KERNEL.launches == before + 1
    want = fv.fused_value_plain(boards, flag, params)
    torch.cuda.synchronize()
    assert got.shape == want.shape == shape
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.gpu
def test_fused_value_kernel_raises_on_what_it_cannot_take():
    dev = _card()
    params = value_net.load_checkpoint(CKPT, device=dev)
    boards = torch.zeros(8, 2, 52, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        fv.fused_value(boards.transpose(0, 1), torch.zeros(2, 8, device=dev), params)
    with pytest.raises(ValueError):
        fv.fused_value(boards, torch.zeros(8, 1, device=dev), value_net.load_checkpoint(CKPT))
