"""The port's value path against the JAX package: encoder, value net (f32 and
bf16), params_from_jax, .pth load/save, and the fused board -> value op.

Tolerances, and why:
* encoder: exact (the same f32 operations on small integers).
* f32 forward: rtol 1e-5 — the same f32 function; only the summation order
  of the 198- and 128-long dots differs.
* bf16 forward and fused_value_plain vs JAX's kernel: max |dv| <= 5e-3. The
  rounding points are the same (operands, hidden activations and w2 in
  bf16, f32 sums), so the only source of difference is an f32 summation
  order that moves a pre-activation across a bf16 rounding boundary: one
  hidden unit then moves by one bf16 ulp (<= 2^-9 in (0, 1)), times |w2|.
* fused_value_plain vs the f32 forward: 2e-2, the bound test_model.py uses
  for the JAX kernel (bf16 G and hidden activations against full f32).
"""
import pathlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.core.config import ModelConfig as JModelConfig
from mlp_ppo_2ply_multi_tpu.encoder import features as jF
from mlp_ppo_2ply_multi_tpu.engine import board as jB
from mlp_ppo_2ply_multi_tpu.model import value_net as jV
from mlp_ppo_2ply_multi_tpu.ops import fused_value as jFV
from mlp_ppo_2ply_multi_tpu_torch.core.config import ModelConfig
from mlp_ppo_2ply_multi_tpu_torch.encoder import features as tF
from mlp_ppo_2ply_multi_tpu_torch.engine import board as tB
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as tV
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as tFV
from tests.helpers import sample_cases

CKPT = str(
    pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "side0_20480000.pth"
)
BF16_TOL = 5e-3


def _cases(seed, n):
    boards, players, _ = sample_cases(seed, n)
    data = np.array(
        [list(b[0]) + list(b[1]) + list(b[2]) + list(b[3]) for b in boards],
        dtype=np.int8,
    )
    return data, np.asarray(players, np.int32)


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_encoder_exact():
    boards, players = _cases(3, 300)
    want = np.asarray(jF.encode_board(jB.Board(jnp.asarray(boards)), jnp.asarray(players)))
    got = tF.encode_board(tB.Board(torch.from_numpy(boards)), torch.from_numpy(players))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_on_checkpoint(dtype):
    jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.load_checkpoint(CKPT, "cpu")
    for k in jparams:
        np.testing.assert_array_equal(np.asarray(jparams[k]), tparams[k].numpy())
    boards, players = _cases(4, 512)
    x = np.asarray(
        jF.encode_board(jB.Board(jnp.asarray(boards)), jnp.asarray(players))
    )
    want = np.asarray(jV.forward(jparams, jnp.asarray(x), JModelConfig(dtype=dtype)))
    got = tV.forward(tparams, torch.from_numpy(np.array(x)), ModelConfig(dtype=dtype)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.max(np.abs(got - want)) <= BF16_TOL


def test_params_from_jax_same_function():
    jparams = jV.init_params(jax.random.PRNGKey(7), JModelConfig())
    tparams = tV.params_from_jax(_np_params(jparams), "cpu")
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(np.asarray(jparams[k]), tparams[k].numpy())
        assert tparams[k].dtype == torch.float32
    x = np.random.default_rng(1).uniform(0, 1, (64, 198)).astype(np.float32)
    want = np.asarray(jV.forward(jparams, jnp.asarray(x), JModelConfig()))
    got = tV.forward(tparams, torch.from_numpy(x), ModelConfig()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_state_dict_roundtrip(tmp_path):
    params = tV.load_checkpoint(CKPT, "cpu")
    path = str(tmp_path / "rt.pth")
    tV.save_checkpoint(params, path)
    again = tV.load_checkpoint(path, "cpu")
    for k in params:
        assert torch.equal(params[k], again[k])
    # the port's state dict is the one the JAX package writes
    want = jV.to_torch_state_dict(jV.load_torch_checkpoint(CKPT))
    got = tV.to_state_dict(params)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_init_params_distribution():
    cfg = ModelConfig()
    p = tV.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = {"w1": (198, 128), "b1": (128,), "w2": (128, 1), "b2": (1,)}
    bounds = {
        "w1": np.sqrt(6.0 / (198 + 128)),
        "b1": 1.0 / np.sqrt(198),
        "w2": np.sqrt(6.0 / 129),
        "b2": 1.0 / np.sqrt(128),
    }
    for k, shape in shapes.items():
        assert tuple(p[k].shape) == shape and p[k].dtype == torch.float32
        assert float(p[k].abs().max()) <= bounds[k]
    # uniform on [-a, a]: mean ~0, std a/sqrt(3)
    w1 = p["w1"].numpy()
    assert abs(w1.mean()) < 0.01 * bounds["w1"] * 10
    assert abs(w1.std() - bounds["w1"] / np.sqrt(3)) < 0.02 * bounds["w1"]
    q = tV.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)


def _fused_inputs(seed, n):
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 16, size=(n, 52), dtype=np.int8)
    flags = rng.integers(0, 2, size=(n,)).astype(np.int32)
    return boards, flags


@pytest.mark.parametrize("params_from", ["init", "checkpoint"])
def test_fused_value_plain_matches_jax_kernel(params_from):
    if params_from == "init":
        jparams = jV.init_params(jax.random.PRNGKey(3), JModelConfig())
    else:
        jparams = jV.load_torch_checkpoint(CKPT)
    tparams = tV.params_from_jax(_np_params(jparams), "cpu")
    boards, flags = _fused_inputs(5, 1000)
    # JAX's Pallas kernel runs in interpret mode on the CPU
    want = np.asarray(jFV.fused_value(jnp.asarray(boards), jnp.asarray(flags), jparams))
    got = tFV.fused_value(torch.from_numpy(boards), torch.from_numpy(flags), tparams)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1000,)
    assert np.max(np.abs(got.numpy() - want)) <= BF16_TOL
    # the plain version is what fused_value routes CPU tensors to
    plain = tFV.fused_value_plain(torch.from_numpy(boards), torch.from_numpy(flags), tparams)
    assert torch.equal(plain, got)
    # recombined params: same algebra, same bf16 rounding points
    for a, b in zip(jFV.recombine_params(jparams), tFV.recombine_params(tparams)):
        np.testing.assert_allclose(
            np.asarray(a, np.float32).reshape(-1), b.float().numpy().reshape(-1),
            rtol=0, atol=float(np.finfo(np.float32).eps) * 4,
        )


def test_fused_value_plain_matches_f32_forward():
    jparams = jV.init_params(jax.random.PRNGKey(3), JModelConfig())
    tparams = tV.params_from_jax(_np_params(jparams), "cpu")
    boards, flags = _fused_inputs(6, 500)
    tb = tB.Board(torch.from_numpy(boards))
    ref = tV.forward(tparams, tF.encode_board(tb, torch.from_numpy(flags)), ModelConfig())
    got = tFV.fused_value(tb.data, torch.from_numpy(flags), tparams)
    assert float((ref - got).abs().max()) < 2e-2
    # batch-shaped [B, A, 52] input with a broadcast flag
    got2 = tFV.fused_value(
        tb.data.reshape(20, 25, 52), torch.from_numpy(flags).reshape(20, 25), tparams
    )
    assert tuple(got2.shape) == (20, 25)
    torch.testing.assert_close(got2.reshape(-1), got, rtol=0, atol=1e-6)
    per_game = tFV.fused_value(
        tb.data.reshape(20, 25, 52), torch.from_numpy(flags[:20])[:, None], tparams
    )
    assert tuple(per_game.shape) == (20, 25)


def test_fused_value_rejects_what_it_cannot_route():
    params = tV.init_params(ModelConfig(), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        tFV.fused_value(torch.zeros(4, 52, dtype=torch.int32), torch.zeros(4), params)
    with pytest.raises(ValueError):
        tFV.fused_value(torch.zeros(4, 51, dtype=torch.int8), torch.zeros(4), params)
    with pytest.raises(ValueError):
        tFV.fused_value(
            torch.zeros(4, 52, dtype=torch.int8, device="meta"), torch.zeros(4), params
        )
    # the kernel's own entry takes CUDA tensors only: never a CPU fallback
    with pytest.raises(ValueError):
        tFV.kernel_operands(torch.zeros(4, 52, dtype=torch.int8), torch.zeros(4), params)

