"""The per-layer metrics read from the program's tracer: each ``read`` on a
synthetic window and tracer record, None where the program has no tracer
(a version before it), and all of them on a small traced cell on the CPU."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.small import run_small
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling

STAGE = {"movegen.graph_ms_per_step": "movegen", "act.graph_ms_per_step": "act",
         "twoply.graph_ms_per_step": "twoply", "env.graph_ms_per_step": "env"}
NEW = [*STAGE, "rollout.launch_wait_ms", "learner.device_ms", "graph.capture_s",
       "graph.pool_mib"]


def _record(update, start, stages, wait, learner_ms):
    return {"update": update, "rollout": (start, start + 0.5), "stages": stages,
            "launch_wait_ms": wait, "learner_ms": learner_ms}


# updates 0 (set-up), 1 and 2 (the window), 3 (profiled after it)
RECORDS = [
    _record(0, 5.0, [{"movegen": 9.0, "act": 2.0, "env": 1.0}], 30.0, 9.0),
    _record(1, 10.1, [{"movegen": 7.0, "act": 1.0, "env": 0.5},
                      {"movegen": 8.0, "act": 1.5, "env": 0.7}], 12.0, 4.0),
    _record(2, 10.7, [{"movegen": 9.0, "act": 0.5, "env": 0.6}], 14.0, None),
    _record(3, 20.0, [{"movegen": 99.0, "act": 99.0, "env": 99.0}], 99.0, 99.0),
]
SPANS = [
    profiling.Span(0, "build", 1.0, -1, -1, {"kernel": "stamp", "cached": False}),
    profiling.Span(1, "capture", 5.1, -1, 0, {"capture_s": 2.5,
                                              "pool_reserved_bytes": 300 * 2**20}),
    profiling.Span(2, "capture", 15.0, -1, 2, {"capture_s": 7.0, "pool_reserved_bytes": 2**30}),
]
WINDOW = [("rollout", 10.0, 10.6), ("learner", 10.6, 10.65), ("pull", 10.65, 10.66),
          ("rollout", 10.66, 11.2), ("learner", 11.2, 11.3), ("pull", 11.3, 11.31)]
WANT = {"movegen.graph_ms_per_step": 8.0, "act.graph_ms_per_step": 1.0,
        "twoply.graph_ms_per_step": None, "env.graph_ms_per_step": 0.6,
        "rollout.launch_wait_ms": 13.0, "learner.device_ms": 4.0, "graph.capture_s": 2.5,
        "graph.pool_mib": 300.0}


@pytest.fixture
def synthetic(monkeypatch):
    def records(t0=None, t1=None):
        return [r for r in RECORDS if t0 <= r["rollout"][0] <= t1]

    monkeypatch.setattr(profiling, "trace_records", records)
    monkeypatch.setattr(profiling, "trace_spans", lambda: list(SPANS))


@pytest.mark.parametrize("name", NEW)
def test_read_on_a_synthetic_record(synthetic, name):
    got = harness.metric_reader(name)(SimpleNamespace(spans=WINDOW))
    want = WANT[name]
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", NEW)
def test_none_without_a_window_or_a_tracer(synthetic, monkeypatch, name):
    read = harness.metric_reader(name)
    assert read(SimpleNamespace(spans=None)) is None
    assert read(SimpleNamespace(spans=[("rollout", 0.5, 0.6)])) is None  # nothing before it
    monkeypatch.delattr(profiling, "trace_records")  # a program without the tracer
    assert read(SimpleNamespace(spans=WINDOW)) is None


def test_every_new_metric_in_a_small_traced_cell(monkeypatch):
    monkeypatch.setenv(profiling.TRACE_ENV, "1")
    profiling.TRACER.reset()
    out = run_small("prod1ply.train", trace=True, seconds=1.0)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"]
    for name in ("movegen.graph_ms_per_step", "act.graph_ms_per_step", "env.graph_ms_per_step",
                 "rollout.launch_wait_ms", "learner.device_ms"):
        assert m[name] >= 0, name
    # no CUDA graph on the CPU: nothing captured in set-up
    assert "graph.capture_s" not in m and "graph.pool_mib" not in m
    assert "twoply.graph_ms_per_step" not in m
    steps = 4  # the small cell's steps an update
    stages = sum(m[f"{s}.graph_ms_per_step"] for s in ("movegen", "act", "env"))
    # the stamped first step of each chunk stands for the chunk's steps
    assert stages * steps + m["rollout.launch_wait_ms"] == \
        pytest.approx(m["actor.rollout_ms_per_update"], rel=0.25)
    assert m["learner.device_ms"] <= m["learner.update_ms"]
