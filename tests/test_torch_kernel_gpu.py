"""The port's CUDA kernels (fused_value, nd_tail) on the card against their
plain PyTorch versions.

These tests need a CUDA card and skip elsewhere (the kernels have no CPU
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
@pytest.mark.parametrize(
    "shape",
    [(4096, 96), (256, 448), (3, 5)]
    # row counts around a warp's 16 rows, the warpgroup's 64-row tile and
    # the CTA's 192 rows (three warpgroups): the ragged tail is masked
    # inside the kernel
    + [(n, 1) for n in (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 191, 192, 193, 4097)],
)
def test_fused_value_kernel_matches_plain(shape):
    """Tier-1 and tier-2 main-path shapes, a ragged tiny one, and row
    counts around the kernel's tiles."""
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
def test_fused_value_kernel_every_count_in_every_cell_both_flags():
    """Rows holding each count 0..15 in every cell (and the int8 extremes,
    which the kernel clamps as the plain version does), both flags in one
    call; and params updated in place are repacked before the next call."""
    dev = _card()
    params = value_net.load_checkpoint(CKPT, device=dev)
    counts = torch.arange(16, device=dev)
    boards = (counts[:, None] + torch.arange(52, device=dev)) % 16  # [16, 52]
    boards = torch.cat([boards, torch.full((2, 52), 127, device=dev),
                        torch.full((2, 52), -128, device=dev)]).to(torch.int8)
    boards = boards.repeat(2, 1)  # 40 rows: each board with flag 0 and 1
    flag = torch.arange(40, device=dev) // 20
    got = fv.fused_value(boards, flag, params)
    want = fv.fused_value_plain(boards, flag, params)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL
    assert not torch.equal(got[:20], got[20:])  # the flag reached the kernel
    with torch.no_grad():
        params["w1"].mul_(0.5)
    got2 = fv.fused_value(boards, flag, params)
    want2 = fv.fused_value_plain(boards, flag, params)
    torch.cuda.synchronize()
    assert float((got2 - want2).abs().max()) <= TOL and not torch.equal(got2, got)


@pytest.mark.gpu
def test_fused_value_kernel_raises_on_what_it_cannot_take():
    dev = _card()
    params = value_net.load_checkpoint(CKPT, device=dev)
    boards = torch.zeros(8, 2, 52, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        fv.fused_value(boards.transpose(0, 1), torch.zeros(2, 8, device=dev), params)
    with pytest.raises(ValueError):
        fv.fused_value(boards, torch.zeros(8, 1, device=dev), value_net.load_checkpoint(CKPT, device="cpu"))


# ---------------------------------------------------------------------------
# nd_tail (kernel B2)
# ---------------------------------------------------------------------------


def _random_positions(n, seed, dev):
    """n positions with 15 checkers a side on disjoint points (some on the
    bar, some borne off, some all home), player to move and a non-double
    roll, as the tail's inputs from the port's front half on the card."""
    import numpy as np

    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
    from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board

    rng = np.random.default_rng(seed)
    data = np.zeros((n, 52), np.int8)
    for r in range(n):
        home = rng.random() < 0.3  # both sides bearing off
        perm = rng.permutation(24)
        for p in (0, 1):
            if home:
                base = 18 if p == 0 else 0
                pts = base + np.nonzero(rng.random(6) < 0.6)[0]
                pts = pts if len(pts) else np.array([base])
                off = int(rng.integers(0, 10))
                bar = 0
            else:
                pts = perm[8 * p : 8 * p + 8]
                off = 0
                bar = int(rng.random() < 0.15)
            data[r, 48 + p], data[r, 50 + p] = bar, off
            for q in rng.choice(pts, size=15 - bar - off):
                data[r, 24 * p + q] += 1
    player = torch.as_tensor(rng.integers(0, 2, n), device=dev)
    pairs = np.array([(a, b) for a in range(1, 7) for b in range(1, 7) if a != b])
    dice = torch.as_tensor(pairs[rng.integers(0, 30, n)], device=dev)
    board = Board(torch.as_tensor(data, device=dev))
    pa, pb, valid, d_hi, d_lo = movegen2._nd_candidates(board, player, dice)
    return valid, pa.b1.data, pb.b1.data, board.data, player, d_hi, d_lo


@pytest.mark.gpu
@pytest.mark.parametrize("rows,K,a_max", [(4096, 96, 96), (1000, 288, 64), (37, 8, 4)])
def test_nd_tail_kernel_matches_plain(rows, K, a_max):
    """The reply path's shape, a wide K with a cap below it, and a tiny
    ragged case that cuts most candidates."""
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    dev = _card()
    inputs = _random_positions(rows, rows + K, dev)
    before = nd_tail.KERNEL.launches
    got = nd_tail.nd_tail_fused(*inputs, K, a_max)
    assert nd_tail.KERNEL.launches == before + 1
    want = nd_tail.nd_tail_plain(*inputs, K, a_max)
    torch.cuda.synchronize()
    for name, a, b in zip(("after", "keep", "n_pre", "pct", "kpair"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name  # `after` too: the kernel clips as the plain version
    assert int(want[2].max()) > min(K, 40)


def _with_counts(inputs, K, seed):
    """The candidate bits cut so that rows cycle through a count of 0, under
    K, exactly K and over K (bits are added at random where a row has too
    few; the tail takes any bits)."""
    import numpy as np

    valid = inputs[0].clone()
    n = valid.shape[0]
    rng = np.random.default_rng(seed)
    extra = torch.as_tensor(rng.random(valid.shape) < 0.5, device=valid.device)
    kind = torch.arange(n, device=valid.device) % 4
    valid[kind >= 2] |= extra[kind >= 2]  # 'exactly K' and 'over K' rows: ~756 set
    rank = torch.cumsum(valid.to(torch.int32), -1)
    limit = torch.stack([torch.zeros_like(kind), torch.full_like(kind, K // 2),
                         torch.full_like(kind, K), torch.full_like(kind, 1512)])
    valid &= rank <= limit.gather(0, kind[None])[0][:, None]
    return (valid,) + tuple(inputs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 31, 32, 33, 96, 288, 576])
def test_nd_tail_kernel_candidate_counts_around_k(K):
    """Rows with 0, under K, exactly K and over K candidates, at K around
    the warp's 32-candidate groups and up to MAX_K."""
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    dev = _card()
    inputs = _with_counts(_random_positions(203, K, dev), K, K)
    n_set = inputs[0].sum(-1)
    assert int((n_set == 0).sum()) > 0 and int((n_set == K).sum()) > 0
    assert int((n_set > K).sum()) > 0
    assert K == 1 or int(((n_set > 0) & (n_set < K)).sum()) > 0
    for a_max in (K, max(1, K // 3)):
        got = nd_tail.nd_tail_fused(*inputs, K, a_max)
        want = nd_tail.nd_tail_plain(*inputs, K, a_max)
        torch.cuda.synchronize()
        for name, a, b in zip(("after", "keep", "n_pre", "pct", "kpair"), got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.equal(a, b), (name, a_max)


@pytest.mark.gpu
def test_single_pass_tail_launches_the_kernel_whatever_the_flag():
    """On a card the single-pass non-doubles tail is the kernel, with
    ``nd_tail_kernel`` off as on."""
    from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
    from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    dev = _card()
    _, _, _, b0, player, d_hi, d_lo = _random_positions(64, 5, dev)
    dice = torch.stack([d_hi, d_lo], -1)
    for flag in (False, True):
        before = nd_tail.KERNEL.launches
        movegen2.enumerate_nondoubles(
            Board(b0), player, dice, MoveGenConfig(nd_tier=0, nd_tail_kernel=flag)
        )
        assert nd_tail.KERNEL.launches == before + 1


@pytest.mark.gpu
def test_nd_tail_kernel_raises_on_what_it_cannot_take():
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    dev = _card()
    inputs = list(_random_positions(8, 1, dev))
    with pytest.raises(ValueError):
        nd_tail.nd_tail_fused(*inputs, 100000, 96)  # K above the kernel's limit
    cpu_b0 = list(inputs)
    cpu_b0[3] = cpu_b0[3].cpu()
    with pytest.raises(ValueError):
        nd_tail.nd_tail_fused(*cpu_b0, 96, 96)
