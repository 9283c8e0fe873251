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
@pytest.mark.parametrize("rows,K,a_max", [(4096, 96, 96), (1000, 288, 64), (37, 8, 4),
                                          (4096, 96, 448), (512, 288, 448)])
def test_nd_tail_kernel_matches_plain(rows, K, a_max):
    """The reply path's shape, a wide K with a cap below it, a tiny ragged
    case that cuts most candidates, and the two-tier tail's shapes at
    ``fast()`` widths (the production cap above K), whose last quarter of
    rows is all-false, as tier 2's sub-batch is beyond its wide games."""
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    dev = _card()
    inputs = _random_positions(rows, rows + K, dev)
    if a_max > K:  # the tier shapes
        valid = inputs[0].clone()
        valid[rows - rows // 4:] = False
        inputs = (valid,) + tuple(inputs[1:])
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


def _wide_mix(n, n_wide, seed, dev):
    """n positions, player to move and a roll: the first ``n_wide`` built
    wide (the mover's checkers on 8-14 points, the opponent's stacked on
    2-4, a non-double roll: most have more than 96 candidates), the rest
    sampled (``oracle.sampling.sample_cases``, doubles included)."""
    import numpy as np

    from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
    from mlp_ppo_2ply_multi_tpu_torch.oracle.sampling import sample_cases

    rng = np.random.default_rng(seed)
    data = np.zeros((n_wide, 52), np.int8)
    player = rng.integers(0, 2, n_wide)
    for r in range(n_wide):
        p, perm = player[r], rng.permutation(24)
        m = int(rng.integers(8, 15))
        np.add.at(data[r], 24 * p + perm[:m], 1)
        np.add.at(data[r], 24 * p + rng.choice(perm[:m], size=15 - m), 1)
        np.add.at(data[r], 24 * (1 - p) + rng.choice(perm[m:m + int(rng.integers(2, 5))],
                                                       size=15), 1)
    pairs = np.array([(a, b) for a in range(1, 7) for b in range(1, 7) if a != b])
    dice = pairs[rng.integers(0, 30, n_wide)]
    boards, players, rolls = sample_cases(seed, n - n_wide)
    sampled = np.array([list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
                       dtype=np.int8)
    as_t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    return (Board(as_t(np.concatenate([data, sampled]))),
            as_t(np.concatenate([player, np.asarray(players)])).to(torch.int32),
            as_t(np.concatenate([dice, np.asarray(rolls)])).to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [4096, 1024])
@pytest.mark.parametrize("call", ["legal_moves_split", "legal_moves"])
def test_two_tier_tail_through_the_kernel_equals_the_plain_route(batch, call, monkeypatch):
    """``legal_moves_split`` and the merged ``legal_moves`` at ``fast()``
    widths, both tiers through the kernel (exactly two launches a
    ``_nd_two_tier`` call), byte-equal in every output tensor, invalid
    slots included, to the same call with the plain ``_nd_tail`` swapped in
    (no launch); with more wide games than tier 2's sub-batch holds, so
    that its overflow branch runs."""
    from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    dev = _card()
    cfg = MoveGenConfig.fast()
    board, player, dice = _wide_mix(batch, batch // 4, batch + 20, dev)
    fn = getattr(movegen2, call)
    per_call, two_tier = [], movegen2._nd_two_tier

    def counted(*a, **k):
        before = nd_tail.KERNEL.launches
        out = two_tier(*a, **k)
        per_call.append(nd_tail.KERNEL.launches - before)
        return out

    monkeypatch.setattr(movegen2, "_nd_two_tier", counted)
    got = fn(board, player, dice, cfg)
    monkeypatch.setattr(nd_tail, "nd_tail_fused", nd_tail.nd_tail_plain)
    want = fn(board, player, dice, cfg)
    torch.cuda.synchronize()
    assert per_call == [2, 0]
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = getattr(a, "data", a), getattr(b, "data", b)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (call, i)
    _, _, valid, _, _ = movegen2._nd_candidates(board, player.long(), dice.long())
    wide = (dice[:, 0] != dice[:, 1]) & (valid.sum(-1) > cfg.nd_tier)
    assert int(wide.sum()) > batch // cfg.nd_wide_div  # past the sub-batch
    assert bool(got.overflow[wide].any())


@pytest.mark.gpu
def test_a_tier_wider_than_the_kernel_raises_on_a_card():
    """The route takes B2 for every signature-dedup pass, whatever its
    width: a tier wider than ``MAX_K`` raises on a card, as the single pass
    does, and never falls back to the plain tail."""
    import dataclasses

    from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail

    dev = _card()
    board, player, dice = _wide_mix(256, 64, 31, dev)
    wide = dataclasses.replace(MoveGenConfig.fast(), nd_dedup_k=nd_tail.MAX_K + 24)
    with pytest.raises(ValueError, match="K <="):
        movegen2.legal_moves_split(board, player, dice, wide)
    single = dataclasses.replace(MoveGenConfig(), nd_dedup_k=nd_tail.MAX_K + 24)
    with pytest.raises(ValueError, match="K <="):
        movegen2.legal_moves(board, player, dice, single)


@pytest.mark.gpu
@pytest.mark.parametrize("call, cfg_name, plain_per_call", [
    ("legal_moves_split", "fast", 2),  # the two tiers
    ("legal_moves", "default", 1),  # the single pass
])
def test_the_gram_dedup_runs_the_plain_tail_and_counts_it(call, cfg_name, plain_per_call,
                                                           monkeypatch):
    """With ``nd_sig_dedup=False`` every pass runs the plain ``_nd_tail`` on
    the card (B2 dedups by signature only): no launch, and each pass counts
    as the tracer's ``nd_tail_plain`` in the update's record."""
    import dataclasses

    from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
    from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
    from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
    from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P

    dev = _card()
    base = MoveGenConfig.fast() if cfg_name == "fast" else MoveGenConfig()
    cfg = dataclasses.replace(base, nd_sig_dedup=False)
    board, player, dice = _wide_mix(256, 64, 32, dev)
    monkeypatch.setenv(P.TRACE_ENV, "1")
    P.TRACER.reset()
    launches = nd_tail.KERNEL.launches
    P.new_update()
    with P.scope("rollout", span=True):
        getattr(movegen2, call)(board, player, dice, cfg)
    P.trace_flush()
    torch.cuda.synchronize()
    (rec,) = P.trace_records()
    P.TRACER.reset()
    assert nd_tail.KERNEL.launches == launches
    assert rec["counters"].get("nd_tail_kernel_launches") == 0
    assert rec["counters"].get("nd_tail_plain") == plain_per_call


# the attribution check, in an interpreter of its own: late in a long test
# process torch.profiler has been seen to collect no device event at all
_ATTRIBUTION = """
import sys, torch
from torch.profiler import ProfilerActivity, profile
from tests.test_torch_kernel_gpu import _wide_mix
from mlp_ppo_2ply_multi_tpu_torch.core.config import MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling
call, cfg = sys.argv[1], MoveGenConfig.fast() if sys.argv[2] == "fast" else MoveGenConfig()
board, player, dice = _wide_mix(1024, 128, 33, torch.device("cuda"))
run = lambda: getattr(movegen2, call)(board, player, dice, cfg)
run()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    run()
    torch.cuda.synchronize()
events = prof.events()
tags = []
for e in events:
    for k in getattr(e, "kernels", None) or []:
        if "nd_tail_kernel" in k.name:
            chain, p = [], e
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            tags.append(profiling.stage_tag(chain[::-1], k.name))
traced = sum("nd_tail_kernel" in e.name for e in profiling.device_events(events))
print(repr((tags, traced)))
"""


@pytest.mark.gpu
@pytest.mark.parametrize("call, cfg_name, want", [
    ("legal_moves_split", "fast", ["nd_tail_t1", "nd_tail_t2"]),
    ("legal_moves", "fast", ["nd_tail_t1", "nd_tail_t2"]),
    ("legal_moves", "default", ["nd_tail"]),  # MoveGenConfig(): the single pass
])
def test_the_eager_attribution_sees_b2_in_its_pass_scopes(call, cfg_name, want):
    """B2 launches inside its dispatcher op, so torch.profiler links each of
    its kernels to that op, and ``stage_tag`` puts it under the scope of its
    pass (the innermost of the tag): every B2 kernel of the trace is
    attributed, in launch order."""
    import ast
    import os
    import subprocess
    import sys

    _card()
    root = pathlib.Path(__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", _ATTRIBUTION, call, cfg_name], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert run.returncode == 0, run.stderr[-3000:]
    tags, traced = ast.literal_eval(run.stdout.strip().splitlines()[-1])
    assert [t.split("/")[-1] for t in tags] == want and traced == len(want), (tags, traced)


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
