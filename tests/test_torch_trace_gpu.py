"""The tracer on the card: device stamps inside the captured chunk graph.

* The stamp kernel writes what its plain version writes: the same cells,
  sequence columns and cursor over a script that wraps past the ring's
  slots, with times that rise in launch order.
* The stamped graph's outputs equal the unstamped graph's (tracing on and
  off capture two graphs of one step).
* The stage ms of a stamped step, with its chunk's input copies and tail,
  sum to within 3% of CUDA events around its replay (a graph of one step,
  queued behind a spin kernel so the events time the graph and not the
  host's launch).
* The wait at an update's first graph launch is read, and not zero; a
  bare replay of the chunk graph (as a timing loop makes) is counted, so
  the updates after it are read whole.
* One update makes the same host synchronisations, counted under
  ``torch.cuda.set_sync_debug_mode("warn")``, with tracing on and off.
* Under torch.profiler, the host spans (``rollout``, ``replay``,
  ``learner``) land within 20 us of their own trace records by
  ``to_profiler_us``, and the device stamps within 20 us of their own
  kernels by ``device_to_profiler_us``.

These tests need a CUDA card and skip elsewhere. The file imports torch
and the port only, so on the card it runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_trace_gpu.py
"""
import dataclasses
import warnings

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core import graphs
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P
from tests.test_torch_graph_gpu import _assert_same
from tests.test_torch_kernel_gpu import CKPT, _card

B = 4096
STEPS, CHUNK = 8, 4


def _production():
    cfg = Config.production()
    return cfg.replace(
        train=dataclasses.replace(cfg.train, td_mode="side0", per_episode_updates=False))


@pytest.fixture
def fresh(monkeypatch):
    """A card, the tracer on and emptied, no graph kept."""
    dev = _card()
    monkeypatch.setenv(P.TRACE_ENV, "1")
    graphs.clear_graphs()
    P.TRACER.reset()
    yield dev
    graphs.clear_graphs()
    P.TRACER.reset()


class _Trainer:
    """The continuous loop body: rollout_chunked, td.update, one pull."""

    def __init__(self, dev, seed=0):
        self.dev, self.cfg = dev, _production()
        params = value_net.load_checkpoint(CKPT, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.state = td.TrainState(params, td.init_adam(params),
                                   torch.zeros((), dtype=torch.int64, device=dev),
                                   torch.zeros((), dtype=torch.int64, device=dev))
        self.env = vec_env.reset(B, self.gen, dev)

    def update(self):
        self.env, traj = rollout.rollout_chunked(
            self.state.params, self.env, 1.0, self.cfg, STEPS, chunk=CHUNK, gen=self.gen,
            device=self.dev)
        self.state, metrics = td.update(self.state, traj, self.cfg, self.dev)
        return td.pack_metrics(metrics)[1].tolist()


@pytest.mark.gpu
def test_stamp_kernel_writes_what_the_plain_version_writes(fresh):
    from mlp_ppo_2ply_multi_tpu_torch.ops import stamp

    script = [(0, 0), (1, 0), (3, 1), (2, 2), (0, 3), (1, 1), (3, 2), (2, 0), (0, 3)]
    ring = torch.full((2, P.WIDTH), -1, dtype=torch.int64)
    cur = torch.zeros(1, dtype=torch.int64)
    dring, dcur = ring.to(fresh), cur.to(fresh)
    for col, close in script:
        stamp.launch_kernel(dring, dcur, col, close)
        stamp.stamp_plain(ring, cur, col, close)
    got = dring.cpu()
    assert int(dcur) == int(cur) == 6
    assert torch.equal(got[:, -1], ring[:, -1]) and torch.equal(got == -1, ring == -1)
    # the stamps left in the ring, in launch order: (slot, column) by the cursor
    kept = [got[0, 1], got[0, 0], got[1, 1], got[0, 3], got[1, 2], got[1, 0]]
    assert all(0 < a <= b for a, b in zip(kept, kept[1:]))


@pytest.mark.gpu
def test_stamped_graph_equals_unstamped(fresh, monkeypatch):
    dev, cfg = fresh, _production()
    params = value_net.load_checkpoint(CKPT, device=dev)
    runs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv(P.TRACE_ENV, flag)
        gen = torch.Generator(device=dev).manual_seed(5)
        state = vec_env.reset(B, gen, dev)
        out = []
        for _ in range(2):  # the first captures, the second replays only
            state, traj = rollout.rollout_chunked(params, state, 1.0, cfg, STEPS, chunk=CHUNK,
                                                  gen=gen, device=dev)
            out.append((state, traj))
        P.trace_flush()
        torch.cuda.synchronize()
        runs[flag] = out
    assert len(graphs.GRAPHS) == 2  # the tracer's state is part of the key
    recs = P.trace_records()
    assert len(recs) == 2 and all(len(r["stages"]) == STEPS // CHUNK for r in recs)
    for on, off in zip(runs["1"], runs["0"]):
        _assert_same(off, on)


@pytest.mark.gpu
def test_stage_sums_match_events_around_the_replay(fresh):
    dev, cfg = fresh, _production()
    params = value_net.load_checkpoint(CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    state = vec_env.reset(B, gen, dev)
    rollout.rollout_chunked(params, state, 1.0, cfg, 2, chunk=1, gen=gen, device=dev)
    g = next(reversed(graphs.GRAPHS.values()))
    P.trace_flush()
    events = []
    for _ in range(5):
        noises = [rollout.draw_noise(B, cfg, gen, dev)]
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10**8)  # the card spins while the host queues the replay
        e0.record()
        g.replay(noises)
        e1.record()
        torch.cuda.synchronize()
        events.append(e0.elapsed_time(e1))
    P.trace_flush()
    torch.cuda.synchronize()
    rec = P.trace_records()[-1]
    stages, chunks = rec["stages"], rec["chunks"]
    assert len(stages) == 5 and all(list(st) == ["movegen", "act", "env"] for st in stages)
    assert len(chunks) == 5
    for st, ch, ev in zip(stages, chunks, events):
        traced = ch["inputs"] + sum(st.values()) + ch["tail"]
        assert abs(traced - ev) <= 0.03 * ev, (st, ch, ev)


@pytest.mark.gpu
def test_launch_wait_is_read_and_not_zero(fresh):
    t = _Trainer(fresh)
    for _ in range(3):
        t.update()
    recs = P.trace_records()
    assert [r["update"] for r in recs] == [0, 1, 2]
    for r in recs[1:]:  # replays only
        assert r["launch_wait_ms"] is not None and r["launch_wait_ms"] > 0
        assert r["learner_ms"] is not None and r["learner_ms"] > 0
        assert r["replays"] == STEPS // CHUNK and r["captures"] == 0
        assert r["lost_rows"] == 0 and r["stale_rows"] == 0
    assert recs[0]["captures"] == 1
    (cap,) = [s for s in P.trace_spans() if s.name == "capture"]
    assert cap.update == 0 and cap.attrs["pool_reserved_bytes"] > 0


@pytest.mark.gpu
def test_a_bare_replay_of_the_graph_is_counted(fresh):
    t = _Trainer(fresh)
    t.update()  # captures
    g = next(reversed(graphs.GRAPHS.values()))
    for _ in range(3):
        g.graph.replay()  # outside ChunkGraph.replay
    t.update()
    t.update()
    P.trace_flush()
    torch.cuda.synchronize()
    recs = [r for r in P.trace_records() if r["rollout"] is not None]
    assert len(recs) == 3
    for r in recs:
        assert (r["lost_rows"], r["stale_rows"]) == (0, 0)
        assert r["launch_wait_ms"] is not None and len(r["stages"]) == STEPS // CHUNK


def _syncs(t, n=1):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                t.update()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted(str(w.message) for w in seen if "synchroniz" in str(w.message).lower())


@pytest.mark.gpu
def test_host_syncs_of_an_update_are_the_same_on_and_off(fresh, monkeypatch):
    got = {}
    for flag in ("0", "1"):
        monkeypatch.setenv(P.TRACE_ENV, flag)
        t = _Trainer(fresh)
        t.update()  # captures
        got[flag] = _syncs(t, 2)
    assert got["1"] == got["0"] and got["1"]  # the pull synchronises, in both


@pytest.mark.gpu
def test_profiled_update_maps_spans_and_stamps_onto_the_trace(fresh):
    from torch.profiler import ProfilerActivity, profile

    t = _Trainer(fresh)
    t.update()
    t.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace's first record pays the profiler's set-up of the thread's
        # buffers inside its entry call (its start lay 40-60 us off on an
        # H100 machine, later records' within 8): not a span's to pay
        with torch.profiler.record_function("first record"):
            pass
        t.update()
        torch.cuda.synchronize()
    rec = P.trace_records()[-1]
    assert rec["update"] == 2
    mine = [s for s in P.TRACER.spans if s.update == 2]
    host = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host.setdefault(e.name, []).append(e.time_range)
    for name in ("rollout", "replay", "learner"):
        spans = sorted((s for s in mine if s.name == name), key=lambda s: s.start)
        traced = sorted(host.get(name, []), key=lambda r: r.start)
        assert len(spans) == len(traced) > 0, name
        for s, r in zip(spans, traced):
            assert abs(P.to_profiler_us(s.start, prof) - r.start) <= 20, (name, s)
            assert abs(P.to_profiler_us(s.end, prof) - r.end) <= 20, (name, s)
    kernels = sorted(e.time_range.start for e in P.device_events(prof.events())
                     if P.STAMP_KERNEL in e.name)
    off = P.device_offset_us(prof)
    stamps = [ns for _, _, ts, _ in rec["rows"] for ns in ts]
    # a chunk's replay stamp, its step's four and its tail's two; the
    # launch stamp and the learner's two
    assert off is not None and len(stamps) == 7 * (STEPS // CHUNK) + 3
    near = [min(abs(P.device_to_profiler_us(ns, prof, off) - k) for k in kernels)
            for ns in stamps]
    # the profiler drops kernel records now and then: most stamps find theirs
    assert sum(d <= 20 for d in near) >= 0.9 * len(stamps), near
