"""The port's ring buffer and profiling utilities against the JAX package's
(``mlp_ppo_2ply_multi_tpu/utils``), on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu.utils import ring_buffer as jring
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling, ring_buffer


def _slices(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.integers(-100, 100, (4,)).astype(np.int8),
             "c": rng.random((4,)) < 0.5} for _ in range(n)]


@pytest.mark.parametrize("capacity,pushes", [(3, 2), (3, 5), (4, 8), (1, 3)])
def test_ring_buffer_push_and_wrap_match_jax(capacity, pushes):
    """The same slices through both rings: store, cursor and filled
    bit-equal after every push, wrap-around included."""
    ex = _slices(1)[0]
    js = jring.init({k: jnp.asarray(v) for k, v in ex.items()}, capacity)
    ts = ring_buffer.init({k: torch.from_numpy(v) for k, v in ex.items()}, capacity)
    for sl in _slices(pushes, seed=1):
        js = jring.push(js, {k: jnp.asarray(v) for k, v in sl.items()})
        ts = ring_buffer.push(ts, {k: torch.from_numpy(v) for k, v in sl.items()})
        assert int(ts.cursor) == int(js.cursor) and int(ts.filled) == int(js.filled)
        assert ts.cursor.dtype == ts.filled.dtype == torch.int32
        for k in ex:
            np.testing.assert_array_equal(ts.store[k].numpy(), np.asarray(js.store[k]))
            assert ts.store[k].numpy().dtype == np.asarray(js.store[k]).dtype


def test_ring_buffer_take_matches_jnp_take():
    """``take`` at injected indices equals ``jnp.take(buf, idx, 0)`` (the
    index draw itself differs: Philox, not threefry)."""
    ex = _slices(1)[0]
    js = jring.init({k: jnp.asarray(v) for k, v in ex.items()}, 5)
    ts = ring_buffer.init({k: torch.from_numpy(v) for k, v in ex.items()}, 5)
    for sl in _slices(7, seed=2):
        js = jring.push(js, {k: jnp.asarray(v) for k, v in sl.items()})
        ring_buffer.push(ts, {k: torch.from_numpy(v) for k, v in sl.items()})
    idx = np.array([4, 0, 0, 3, 1, 2, 4, 2], np.int32)
    got = ring_buffer.take(ts, torch.from_numpy(idx))
    for k, buf in js.store.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jnp.take(buf, idx, axis=0)))


def test_ring_buffer_sample_draws_filled_slots_only():
    """Samples come from [0, max(filled, 1)), all of them reachable, and
    the draw follows the generator's seed."""
    ts = ring_buffer.init({"a": torch.zeros(2)}, 8)
    idx = ring_buffer.sample_indices(ts, torch.Generator().manual_seed(0), 64)
    assert idx.dtype == torch.int64 and bool((idx == 0).all())  # empty ring: slot 0
    for i in range(3):
        ring_buffer.push(ts, {"a": torch.full((2,), float(i))})
    out = ring_buffer.sample(ts, torch.Generator().manual_seed(1), 256)
    assert out["a"].shape == (256, 2)
    assert set(out["a"][:, 0].tolist()) == {0.0, 1.0, 2.0}
    again = ring_buffer.sample(ts, torch.Generator().manual_seed(1), 256)
    assert torch.equal(out["a"], again["a"])


def test_ring_buffer_push_keeps_its_tensors():
    """``push`` writes in place: the state's tensors stay the same objects,
    so a CUDA graph that captured a push replays into them."""
    ts = ring_buffer.init({"a": torch.zeros(3)}, 2)
    ptrs = (ts.store["a"].data_ptr(), ts.cursor.data_ptr(), ts.filled.data_ptr())
    out = ring_buffer.push(ts, {"a": torch.ones(3)})
    assert out is ts
    assert (ts.store["a"].data_ptr(), ts.cursor.data_ptr(), ts.filled.data_ptr()) == ptrs


def test_device_memory_stats_and_op_times_never_raise_on_the_cpu():
    """Like JAX's ``device_memory_stats`` on the CPU: {} (no card), and the
    op view keeps device events only, so a CPU run has none."""
    assert profiling.device_memory_stats("cpu") == {}
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    assert profiling.device_op_times(fn, torch.ones(8, 8)) == {}
    assert calls == [1]
    profiling.synchronize({"a": [torch.ones(1)], "b": (torch.zeros(1),)})
