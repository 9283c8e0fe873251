"""The port's tracer (``utils.profiling``) on the CPU, where a stamp is the
host's ``perf_counter_ns`` and every piece of its bookkeeping runs.

* Stage order and names: a rollout of each branch of the step (1-ply split
  planes, merged, tiered; 2-ply) at small widths and B = 8 stamps the first
  step of each chunk with its stages in order, each chunk's replay and tail
  around it, on the host spans' clock; the chunks' parts (input copies,
  stamped step, tail, the gap since the last chunk) tile each span.
* Tracing on and off give bit-equal trajectories; off keeps nothing.
* The ring: rows beyond its slots are lost, counted, and the rest read; a
  graph's replayed rows are counted by the host, and a replay it did not
  count leaves the update's rows stale rather than misread.
* Window selection by the ``rollout`` span's host start; span parents and
  self time; the build span and counters; a span scope's one kind of
  profiler record, on and off; host spans on a torch.profiler timeline.
* The new scope names match none of the stage patterns that the eager
  attribution reads (``benchmark/trace.py``, ``profiling.STAGE_RE``).
* ``apps.train`` writes ``trace/*`` scalars at --log-every and a Chrome
  trace at --trace-out.

The card's side (the stamp kernel inside captured graphs, the clocks of a
profiled update): tests/test_torch_trace_gpu.py.
"""
import dataclasses
import json
import time

import pytest
import torch

from benchmark.trace import MOVEGEN_RE, REPLY_RE
from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.apps import train
from mlp_ppo_2ply_multi_tpu_torch.core.config import (Config, ModelConfig, MoveGenConfig,
                                                      TrainConfig)
from mlp_ppo_2ply_multi_tpu_torch.core.tree import leaves
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.learner import td
from mlp_ppo_2ply_multi_tpu_torch.ops import _cuda_build, stamp
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P

B = 8
STEPS, CHUNK = 8, 4
WIDTHS = dict(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, nd_tier=16,
              nd_wide_div=4, dd_subbatch_div=3)
NEW_SCOPES = ("movegen", "act", "twoply", "env", "rollout", "replay", "learner", "capture",
              "build")
STAGES = {"split": ["movegen", "act", "env"], "merged": ["movegen", "act", "env"],
          "tiered": ["movegen", "act", "env"], "twoply": ["movegen", "twoply", "env"]}


def config(path: str) -> Config:
    """The small configuration of each branch of ``rollout_step``."""
    train_cfg = TrainConfig(td_mode="side0")
    merged = Config(movegen=MoveGenConfig(**WIDTHS), train=train_cfg)
    fused = ModelConfig(fused_actor_kernel=True, actor_tier_width=16, actor_tier_wide_div=4,
                        dtype="bfloat16")
    if path == "merged":
        return merged
    if path == "twoply":
        return merged.replace(twoply=dataclasses.replace(merged.twoply, enabled=True,
                                                         reply_a_max=16))
    if path == "tiered":
        mg = MoveGenConfig(**WIDTHS, split_planes=True, tiered=True, dd_tier=(8, 8, 16),
                           tiered_wide_div=4)
        return Config(movegen=mg, model=fused, train=train_cfg)
    return Config(movegen=MoveGenConfig(**WIDTHS, split_planes=True), model=fused,
                  train=train_cfg)


@pytest.fixture(autouse=True)
def tracer(monkeypatch):
    """The tracer on and emptied; one torch thread (several test workers)."""
    monkeypatch.setenv(P.TRACE_ENV, "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    slots = P.TRACER.slots
    P.TRACER.reset()
    yield P.TRACER
    P.TRACER.slots = slots
    P.TRACER.reset()
    torch.set_num_threads(n)


def _update(cfg, seed=0, steps=STEPS, chunk=CHUNK, learner=True, state=None):
    """One continuous update on the CPU: rollout_chunked, then td.update."""
    gen = torch.Generator().manual_seed(seed)
    ts = state or td.init_train_state(cfg, gen, "cpu")
    env = vec_env.reset(B, gen, "cpu")
    env, traj = rollout.rollout_chunked(ts.params, env, 1.0, cfg, steps, chunk=chunk, gen=gen,
                                        device="cpu")
    if learner:
        ts, _ = td.update(ts, traj, cfg, "cpu")
    return ts, env, traj


@pytest.mark.parametrize("path", ["split", "merged", "tiered", "twoply"])
def test_stamped_stages_in_order_on_every_branch(path):
    _update(config(path))
    (rec,) = P.trace_records()
    assert [k for k, *_ in rec["rows"]] == ["replay", "launch", "step", "tail",
                                            "replay", "step", "tail", "learner"]
    assert [list(st) for st in rec["stages"]] == [STAGES[path]] * (STEPS // CHUNK)
    assert all(ms >= 0 for st in rec["stages"] for ms in st.values())
    chunks = rec["chunks"]
    assert len(chunks) == STEPS // CHUNK and chunks[0]["gap"] is None and chunks[1]["gap"] >= 0
    for c, st in zip(chunks, rec["stages"]):
        assert c["step"] == pytest.approx(sum(st.values()))
        assert min(c["inputs"], c["tail"]) >= 0 and c["inputs"] >= rec["launch_wait_ms"] * (
            c is chunks[0])
        # the unstamped steps lie between the stamped one and the tail
        assert c["inputs"] + c["step"] + c["tail"] <= c["span"]
    # on the CPU a stamp is perf_counter_ns, the host spans' clock
    stamps = [ns for _, _, ts, _ in rec["rows"] for ns in ts]
    assert stamps == sorted(stamps)
    t0, t1 = rec["rollout"]
    assert t0 <= stamps[0] / 1e9 and stamps[-3] / 1e9 <= t1  # the learner's two come after
    assert rec["learner"][0] <= stamps[-2] / 1e9 <= stamps[-1] / 1e9 <= rec["learner"][1]
    assert rec["launch_wait_ms"] >= 0 and rec["learner_ms"] > 0
    assert (rec["lost_rows"], rec["stale_rows"], rec["replays"]) == (0, 0, 0)


def test_trajectories_bit_equal_with_tracing_on_and_off(monkeypatch):
    cfg = config("split")
    on = _update(cfg, seed=3, learner=False)
    monkeypatch.setenv(P.TRACE_ENV, "0")
    off = _update(cfg, seed=3, learner=False)
    for a, b in zip(leaves(on[1:]), leaves(off[1:])):
        assert torch.equal(a, b)
    P.trace_flush()
    assert len(P.trace_records()) == 1  # the traced one


def test_trace_off_keeps_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(P.TRACE_ENV, "0")
    assert not P.tracing()
    _update(config("merged"))
    with P.scope("outer", span=True, a=1) as attrs:
        attrs["b"] = 2
    with P.scope("capture", span=True):  # a set-up span, which would count
        pass
    P.launch_stamp(torch.device("cpu"))
    P.trace_flush()
    t = P.TRACER
    assert (list(t.spans), list(t.setup), P.trace_records(), dict(t.counters), t.rings) == \
        ([], [], [], {}, {})
    assert P.trace_summary() == {} and P.chrome_trace()["traceEvents"] == []


def test_ring_wrap_and_the_hosts_slot_bookkeeping(tracer):
    tracer.slots = 8
    tracer.reset()
    cfg = config("merged")
    # launch, 8 chunks of (replay, step, tail), learner: 26 rows in 8 slots,
    # the last 8 read: the tail of chunk 6, then chunks 7 and 8 and the learner
    ts, _, _ = _update(cfg, steps=8, chunk=1)
    first = P.trace_records()[0]
    assert first["lost_rows"] == 18 and first["stale_rows"] == 0
    assert len(first["stages"]) == 2 and first["launch_wait_ms"] is None
    assert first["learner_ms"] > 0
    assert len(first["chunks"]) == 2 and first["chunks"][0]["gap"] is not None
    # launch, 2 chunks, learner: 8 rows, none lost
    _update(cfg, steps=2, chunk=1, state=ts)
    second = P.trace_records()[1]
    assert second["lost_rows"] == 0 and len(second["stages"]) == 2
    assert second["launch_wait_ms"] is not None and len(second["chunks"]) == 2
    ring = tracer.rings["cpu"]
    assert ring.launched == 34 and int(ring.cursor) == 34

    # a graph's rows: its kernels stamp at each replay, the host counts them
    rows = [P._Row("step", ("movegen", "act", "end"), ring, -1)]

    def replay():  # what the captured stamp kernels do on the device
        for col in range(3):
            stamp.stamp(ring.buf, ring.cursor, col, P.KINDS["step"] if col == 2 else 0)

    for _ in range(3):
        replay()
        tracer.replayed(rows)
    P.trace_flush()
    rec = P.trace_records()[-1]
    assert len(rec["stages"]) == 3 and (rec["lost_rows"], rec["stale_rows"]) == (0, 0)
    replay()  # a replay the host did not count: the cursor runs one ahead
    replay()
    tracer.replayed(rows)
    P.launch_stamp(torch.device("cpu"))
    P.trace_flush()
    rec = P.trace_records()[-1]
    # the host's step row would find a step row in its slot (the uncounted
    # one): the cursor the update closed at, one past the host's count,
    # leaves both rows out rather than misread
    assert rec["stale_rows"] == 2 and rec["stages"] == [] and rec["launch_wait_ms"] is None
    assert ring.launched == 39 and int(ring.cursor) == 40


def test_window_selection_by_host_time():
    cfg = config("merged")
    marks = [time.perf_counter()]
    ts = None
    for _ in range(3):
        ts, _, _ = _update(cfg, steps=4, state=ts)
        marks.append(time.perf_counter())
    td.update(ts, _update(cfg, steps=4, learner=False)[2], cfg, "cpu")  # no rollout span of its own
    recs = P.trace_records()
    assert [r["update"] for r in recs] == [0, 1, 2, 3]
    assert [r["update"] for r in P.trace_records(marks[1], marks[3])] == [1, 2]
    assert [r["update"] for r in P.trace_records(marks[0], marks[1])] == [0]
    start = recs[2]["rollout"][0]
    assert [r["update"] for r in P.trace_records(start, start)] == [2]  # bounds included
    assert [r["update"] for r in P.trace_records(t1=marks[1])] == [0]
    assert P.trace_records(marks[3] + 3600, None) == []


def test_span_parents_and_self_time():
    with P.scope("outer", span=True, what="x") as attrs:
        time.sleep(0.02)
        with P.scope("inner", span=True):
            time.sleep(0.03)
            assert P.scopes() == ("outer", "inner")
        attrs["n"] = 3
    inner, outer = list(P.TRACER.spans)
    assert (outer.name, inner.name) == ("outer", "inner")
    assert inner.parent == outer.id and outer.parent == -1
    assert outer.attrs == {"what": "x", "n": 3} and outer.update == -1
    assert outer.start <= inner.start <= inner.end <= outer.end
    own = P.span_self_seconds([outer, inner])
    assert own[inner.id] == inner.seconds
    assert own[outer.id] == pytest.approx(outer.seconds - inner.seconds)
    assert 0.015 <= own[outer.id] < outer.seconds and inner.seconds >= 0.025
    P.new_update()
    with P.scope("rollout", span=True):
        pass
    assert P.TRACER.spans[-1].update == 0


def test_build_span_and_counters(monkeypatch, tmp_path):
    monkeypatch.setattr(P, "KERNELS", [])
    k = _cuda_build.CudaKernel(tmp_path / "k.cu", lambda lib: None)
    monkeypatch.setattr(_cuda_build, "build",
                        lambda src: (src, {"path": str(src), "cached": True, "ptxas": ""}))
    monkeypatch.setattr(_cuda_build.ctypes, "CDLL", lambda path: object())
    P.new_update()
    k.load()
    k.load()  # loaded once
    (sp,) = P.trace_spans()
    assert sp.name == "build" and sp.attrs == {"kernel": "k", "cached": True, "seconds": 0.0}
    assert P.TRACER.counters["builds"] == 1
    with P.scope("capture", span=True, what="a graph"):  # counted as it closes
        pass
    P.trace_flush()
    (rec,) = P.trace_records()
    assert (rec["builds"], rec["captures"], rec["rollout"]) == (1, 1, None)


def test_new_scope_names_match_no_stage_pattern():
    for name in NEW_SCOPES:
        for pattern in (MOVEGEN_RE, REPLY_RE, P.STAGE_RE):
            assert not pattern.fullmatch(name), (name, pattern.pattern)
    # and the step enters the stage scopes around the JAX ones
    from torch.profiler import ProfilerActivity, profile

    cfg = config("split")
    gen = torch.Generator().manual_seed(0)
    ts = td.init_train_state(cfg, gen, "cpu")
    env = vec_env.reset(B, gen, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rollout.rollout_step(ts.params, env, 1.0, cfg, True, gen=gen, device="cpu")
    names = {e.name for e in prof.events() if e.is_user_annotation}
    assert {"movegen", "act", "env", "nd_front", "act_t1", "env_step"} <= names


def test_host_spans_on_a_profiler_timeline():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with P.scope("mark", span=True):
                torch.ones(64).sum()
    traced = sorted(e.time_range.start for e in prof.events() if e.name == "mark")
    mine = sorted(s.start for s in P.TRACER.spans if s.name == "mark")
    assert len(traced) == len(mine) == 3
    # the same clock: within what a loaded host takes to return from the
    # record_function (the card's test holds 20 us)
    for t, r in zip(mine, traced):
        assert abs(P.to_profiler_us(t, prof) - r) < 5e3


@pytest.mark.parametrize("flag", ["1", "0"])
def test_span_scopes_make_one_kind_of_trace_record_on_and_off(monkeypatch, flag):
    """A span's scope is the same profiler record whether the tracer keeps
    the span or not; a plain scope stays a user annotation."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv(P.TRACE_ENV, flag)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.scope("rollout", span=True):
            with P.scope("nd_front"):
                torch.ones(4).sum()
    kinds = {e.name: e.is_user_annotation for e in prof.events()
             if e.name in ("rollout", "nd_front")}
    assert kinds == {"rollout": False, "nd_front": True}
    assert len(P.TRACER.spans) == (flag == "1")


def test_stamp_plain_writes_host_time_and_sequence():
    ring = torch.zeros((3, P.WIDTH), dtype=torch.int64)
    cur = torch.zeros(1, dtype=torch.int64)
    t0 = time.perf_counter_ns()
    for _ in range(4):
        stamp.stamp(ring, cur, 0)
        stamp.stamp(ring, cur, 1, close=5)
    assert int(cur) == 4
    assert ring[:, -1].tolist() == [3 * 8 + 5, 1 * 8 + 5, 2 * 8 + 5]
    assert (ring[:, :2] >= t0).all()
    assert (ring[:, 1] >= ring[:, 0]).all() and (ring[:, 2:4] == 0).all()
    with pytest.raises(ValueError):
        stamp.stamp(ring, cur, P.WIDTH - 1)
    with pytest.raises(ValueError):
        stamp.stamp(ring, cur, 0, close=8)
    with pytest.raises(ValueError):
        stamp.stamp(ring.int(), cur, 0)
    with pytest.raises(ValueError):
        stamp.stamp(ring.to("meta"), cur.to("meta"), 0)


def test_train_cli_writes_trace_scalars_and_a_chrome_trace(tmp_path):
    out = tmp_path / "trace.json"
    rc = train.main(["--device", "cpu", "--small-movegen", "--batch-games", "8", "--updates",
                     "2", "--steps-per-update", "8", "--log-every", "1", "--histograms-every", "0",
                     "--checkpoint-dir", str(tmp_path / "ck"),
                     "--metrics-dir", str(tmp_path / "runs"), "--trace-out", str(out)])
    assert rc == 0
    (run,) = (tmp_path / "runs").iterdir()
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    for line in lines:
        for key in ("movegen", "act", "env"):
            assert line[f"trace/{key}_ms"] > 0
        assert line["trace/launch_wait_ms"] >= 0 and line["trace/learner_device_ms"] > 0
        assert line["trace/captures"] == 0 and line["trace/builds"] == 0
    events = json.loads(out.read_text())["traceEvents"]
    host = [e for e in events if e["tid"] == "host"]
    dev = [e for e in events if e["tid"] == "device cpu"]
    assert {e["name"] for e in host} >= {"rollout", "learner"}
    assert {e["name"] for e in dev} == {"movegen", "act", "env", "launch", "replay", "tail",
                                        "learner"}
    # one timeline: each update's device stages lie inside its rollout span
    for r in (e for e in host if e["name"] == "rollout"):
        inside = [e for e in dev if e["args"]["update"] == r["args"]["update"]
                  and e["name"] == "movegen"]
        assert len(inside) == 2
        assert all(r["ts"] <= e["ts"] <= r["ts"] + r["dur"] for e in inside)
