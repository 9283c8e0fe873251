"""Device-side transition ring buffer.

Port of ``mlp_ppo_2ply_multi_tpu/utils/ring_buffer.py``: the working
equivalent of the reference's ``RingReplayBuffer``
(ring_replay_buffer.py), whose ``sample_episodes`` is a stub. A ring of
``capacity`` slices (a dict of tensors, e.g. one [B, ...] transition batch)
lives on the slices' device, is written by rollout windows and sampled
uniformly. On-policy TD(0) training does not need it (each trajectory
window is consumed whole); it exists for capability parity.

``push`` writes in place at the cursor and moves the 0-d counters on the
device, so it never waits on the host and can sit inside a captured CUDA
graph. ``sample`` draws its indices from the caller's ``torch.Generator``
(Philox, not JAX's threefry, so the same seed draws other slots);
``take`` reads the slots at given indices, the part both packages share.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class RingState(NamedTuple):
    store: Dict[str, torch.Tensor]  # [CAP, ...] per key
    cursor: torch.Tensor  # int32 0-d: next write slot
    filled: torch.Tensor  # int32 0-d: number of valid slots


def init(example_slice: Dict[str, torch.Tensor], capacity: int) -> RingState:
    """A ring of ``capacity`` zero slices shaped, typed and placed like
    ``example_slice``; cursor and filled 0."""
    store = {
        k: torch.zeros((capacity, *v.shape), dtype=v.dtype, device=v.device)
        for k, v in example_slice.items()
    }
    dev = next(iter(example_slice.values())).device
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    return RingState(store=store, cursor=zero(), filled=zero())


def push(state: RingState, slice_: Dict[str, torch.Tensor]) -> RingState:
    """Write ``slice_`` at the cursor, advance it (mod capacity) and count
    the slot, all in place on the device. Returns ``state``."""
    cap = next(iter(state.store.values())).shape[0]
    at = state.cursor.to(torch.int64).view(1)
    for k, buf in state.store.items():
        buf.index_copy_(0, at, slice_[k].to(buf.dtype).unsqueeze(0))
    state.cursor.copy_(torch.remainder(state.cursor + 1, cap))
    state.filled.copy_(torch.clamp(state.filled + 1, max=cap))
    return state


def take(state: RingState, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The stored slices at ``idx`` (int [n]), ``jnp.take(buf, idx, 0)``."""
    return {k: buf.index_select(0, idx.to(torch.int64)) for k, buf in state.store.items()}


def sample_indices(state: RingState, gen: torch.Generator, n: int) -> torch.Tensor:
    """``n`` slots drawn uniformly, with replacement, from
    [0, max(filled, 1)) by ``gen`` on the ring's device; no host sync."""
    hi = torch.clamp(state.filled, min=1).to(torch.int64)
    u = torch.rand(n, generator=gen, device=state.filled.device, dtype=torch.float64)
    return torch.minimum((u * hi).to(torch.int64), hi - 1)


def sample(state: RingState, gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """Uniformly sample ``n`` stored slices (with replacement); what the
    reference left as a stub (ring_replay_buffer.py:11-13)."""
    return take(state, sample_indices(state, gen, n))
