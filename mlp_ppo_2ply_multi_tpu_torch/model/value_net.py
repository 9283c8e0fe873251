"""Sigmoid MLP value network (198 -> hidden -> 1).

Port of ``mlp_ppo_2ply_multi_tpu/model/value_net.py``. Parameters are a plain
dict in the JAX package's (in, out) layout — ``w1 [198, h]``, ``b1 [h]``,
``w2 [h, 1]``, ``b2 [1]`` — so both packages hold the same numbers; the
reference's .pth state dicts (``fc1.*``, ``value_head.*``, torch's (out, in)
layout) load and save natively.

The bfloat16 path reproduces JAX's ``jnp.dot(a_bf16, b_bf16,
preferred_element_type=f32)``: operands are rounded to bf16, then multiplied
in float32. A bf16 x bf16 product is exact in float32, so the only freedom
left is the summation order. TF32 must be off for that on the card
(PyTorch's default for matmuls; ``forward`` does not change it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import ModelConfig
from mlp_ppo_2ply_multi_tpu_torch.core.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Params:
    """Xavier-uniform weights and torch-Linear-default uniform biases — the
    reference's distributions (policy_network.py:50-51), on ``device``
    (default ``cuda``). Draws come from ``generator``, so only the
    distribution matches the JAX package."""
    in_s, h = cfg.input_size, cfg.hidden_size
    dev = resolve_device(device)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)
        return (2.0 * u - 1.0) * bound

    return {
        "w1": uniform((in_s, h), math.sqrt(6.0 / (in_s + h))),
        "b1": uniform((h,), 1.0 / math.sqrt(in_s)),
        "w2": uniform((h, 1), math.sqrt(6.0 / (h + 1))),
        "b2": uniform((1,), 1.0 / math.sqrt(h)),
    }


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def forward(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """V(x) for feature batches of any leading shape [..., 198] -> [...] f32.

    Reference policy_network.py:53-70: sigmoid hidden, linear head. With
    ``cfg.dtype == "bfloat16"`` the operands of both products are rounded to
    bf16 and the products accumulate in float32, as in JAX."""
    if cfg.model_axis is not None:
        raise NotImplementedError("tensor-parallel value net is not ported")
    w1, w2 = params["w1"].float(), params["w2"].float()
    x = x.float()
    if cfg.dtype == "bfloat16":
        x, w1, w2 = _round_bf16(x), _round_bf16(w1), _round_bf16(w2)
    h = torch.sigmoid(x @ w1 + params["b1"].float())
    if cfg.dtype == "bfloat16":
        h = _round_bf16(h)
    return (h @ w2 + params["b2"].float()).squeeze(-1)


def forward_np(params, x: np.ndarray) -> np.ndarray:
    """Pure-numpy f32 forward for host-side single-game use (the play CLI):
    the JAX package's ``forward_np``. ``params`` hold numpy arrays (or CPU
    tensors); ``x`` is f32 [..., 198]."""
    p = {k: np.asarray(v) for k, v in params.items()}
    h = 1.0 / (1.0 + np.exp(-(x @ p["w1"] + p["b1"])))
    return (h @ p["w2"] + p["b2"])[..., 0]


def params_from_jax(params: Dict[str, np.ndarray], device: DeviceLike = None) -> Params:
    """The JAX pytree (numpy arrays w1 [198,h], b1 [h], w2 [h,1], b2 [1]) as
    the port's parameters on ``device`` (default ``cuda``): the same numbers
    in the same layout."""
    dev = resolve_device(device)
    return {
        k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
        for k in ("w1", "b1", "w2", "b2")
    }


# ---------------------------------------------------------------------------
# .pth interop (state dict keys fc1.weight/fc1.bias/value_head.weight/
# value_head.bias, torch (out, in) layout)
# ---------------------------------------------------------------------------


def from_state_dict(sd, device: DeviceLike = None) -> Params:
    """A .pth state dict as params on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    t = lambda k: sd[k].detach().to(device=dev, dtype=torch.float32)
    return {
        "w1": t("fc1.weight").T.contiguous(),  # (h,198) -> (198,h)
        "b1": t("fc1.bias").clone(),
        "w2": t("value_head.weight").T.contiguous(),  # (1,h) -> (h,1)
        "b2": t("value_head.bias").clone(),
    }


def to_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    cpu = lambda k: params[k].detach().cpu()
    return {
        "fc1.weight": cpu("w1").T.contiguous(),
        "fc1.bias": cpu("b1").clone(),
        "value_head.weight": cpu("w2").T.contiguous(),
        "value_head.bias": cpu("b2").clone(),
    }


def load_checkpoint(path: str, device: DeviceLike = None) -> Params:
    """A .pth file as params on ``device`` (default ``cuda``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_state_dict(sd, device)


def save_checkpoint(params: Params, path: str) -> None:
    torch.save(to_state_dict(params), path)
