"""The port's row take (``ops.take_rows``, counterpart of the probe kernels
P1-P3 of ``scripts/probe_pallas_batched_dot.py``) and its probe entry point,
on the CPU.

``take_rows_plain`` is held against numpy's ``take_along_axis`` (the probe's
own reference), against ``torch.gather`` for in-range indices and, for
indices outside [0, W), against P1/P2's one-hot product written in jnp.
All results are int8 and must be bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.ops import take_rows as tr
from mlp_ppo_2ply_multi_tpu_torch.scripts import probe_take

SHAPES = [(64, 128, 128), (37, 448, 96), (5, 7, 3), (1, 1, 1)]  # (N, W, K)


def _inputs(seed, n, w, k, c=52, dtype=np.int32, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    boards = rng.integers(-128, 128, (n, w, c)).astype(np.int8)
    idx = rng.integers(lo, w if hi is None else hi, (n, k)).astype(dtype)
    return boards, idx


@pytest.mark.parametrize("n,w,k", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_take_matches_take_along_axis(n, w, k, dtype):
    boards, idx = _inputs(n * 7 + k, n, w, k, dtype=dtype)
    got = tr.take_rows(torch.from_numpy(boards), torch.from_numpy(idx))
    want = np.take_along_axis(boards, idx[..., None].astype(np.int64), axis=1)
    assert got.dtype == torch.int8 and got.shape == (n, k, 52)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,w,k", SHAPES[:3])
def test_plain_take_matches_torch_gather(n, w, k):
    boards, idx = _inputs(3 + k, n, w, k)
    b, i = torch.from_numpy(boards), torch.from_numpy(idx)
    want = torch.gather(b, 1, i.long()[..., None].expand(n, k, 52))
    assert torch.equal(tr.take_rows_plain(b, i), want)


def _one_hot_take(boards, parent):
    """P1/P2 (probe_pallas_batched_dot.py :30-58, :75-84): a bf16 one-hot
    [N, K, W] times the boards as bf16, f32 accumulation, cast to int8."""
    w = boards.shape[1]
    oh = (parent[..., None] == jnp.arange(w, dtype=jnp.int32)).astype(jnp.bfloat16)
    out = jax.lax.dot_general(
        oh, boards.astype(jnp.bfloat16), (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )
    return np.asarray(out.astype(jnp.int8))


def test_plain_take_out_of_range_rows_are_the_one_hot_products():
    """Indices below 0 and at or above W: zero rows, as P1/P2's one-hot with
    no match gives; in-range rows taken as usual. Boards in 0..4 as the
    probe draws them (bf16 holds every int8, so the product is exact)."""
    n, w, k = 16, 24, 40
    rng = np.random.default_rng(5)
    boards = rng.integers(0, 5, (n, w, 52)).astype(np.int8)
    idx = rng.integers(-3, w + 4, (n, k)).astype(np.int32)
    idx[0, :4] = [-1, w, w + 100, -(2**31)]
    assert (idx < 0).any() and (idx >= w).any() and ((idx >= 0) & (idx < w)).any()
    want = _one_hot_take(jnp.asarray(boards), jnp.asarray(idx))
    got = tr.take_rows(torch.from_numpy(boards), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    outside = (idx < 0) | (idx >= w)
    assert not got.numpy()[outside].any()


def test_take_rows_routes_by_device_and_checks_its_inputs():
    boards, idx = _inputs(1, 4, 8, 6)
    b, i = torch.from_numpy(boards), torch.from_numpy(idx)
    before = tr.KERNEL.launches
    tr.take_rows(b, i)
    assert tr.KERNEL.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        tr.take_rows(b.to("meta"), i.to("meta"))
    with pytest.raises(ValueError):
        tr.launch_kernel(b, i)  # the kernel runs on cuda only
    with pytest.raises(ValueError):
        tr.take_rows(b.to(torch.int16), i)
    with pytest.raises(ValueError):
        tr.take_rows(b, i.to(torch.float32))
    with pytest.raises(ValueError):
        tr.take_rows(b, i[:3])
    with pytest.raises(TypeError):
        tr.take_rows(boards, i)
    empty = tr.take_rows(b, i[:, :0])
    assert empty.shape == (4, 0, 52)


@pytest.mark.parametrize("mode", ["batched", "fused", "bdiag8", "gather", "plain"])
def test_probe_entry_point_is_exact_on_the_cpu(mode, capsys):
    rc = probe_take.main([mode, "64", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0] == "exact: True"
    assert out[1].startswith(f"{mode}: ") and "[64,128,128]x[64,128,52]" in out[1]


def test_probe_inputs_have_the_jax_scripts_shapes_and_ranges():
    boards, parent = probe_take.inputs(32, torch.device("cpu"))
    assert boards.dtype == torch.int8 and boards.shape == (32, 128, 52)
    assert parent.dtype == torch.int32 and parent.shape == (32, 128)
    assert int(boards.min()) == 0 and int(boards.max()) == 4
    assert int(parent.min()) >= 0 and int(parent.max()) < 128
