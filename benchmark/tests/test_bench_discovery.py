"""A configuration, a traffic mix and a per-layer metric added as new files
(and entries in ``BENCHMARK.json``) are found by name and run, with no edit
to a file the benchmark already has."""
import hashlib
import json
import shutil
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.small import OVERRIDES

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

METRIC = '''"""Updates the window completed (a test metric)."""


def read(ctx):
    return float(len(ctx.counts)) if ctx.counts is not None else None
'''


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _checkout(root: Path) -> None:
    """BENCHMARK.json, the benchmark's folder and the weights file it reads."""
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    weights = json.loads((BENCH / "configs" / "prod1ply.json").read_text())["weights"]
    (root / weights).parent.mkdir(parents=True)
    shutil.copy(REPO / weights, root / weights)


def test_new_config_mix_and_metric_found(tmp_path):
    _checkout(tmp_path)
    before = _digest(tmp_path)
    b = tmp_path / BENCH.name
    conf = json.loads((b / "configs" / "prod1ply.json").read_text())
    conf.update(name="tiny1ply", batch_games=24, steps_per_update=4)
    (b / "configs" / "tiny1ply.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "train.json").read_text())
    mix.update(OVERRIDES["prod1ply.train"]["traffic"], checked_updates=2)
    (b / "traffic" / "short.json").write_text(json.dumps(mix))
    (b / "metrics" / "test.updates_traced.py").write_text(METRIC)
    (b / "limits" / "tiny1ply.short.json").write_text(
        (b / "limits" / "prod1ply.train.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny1ply", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/tiny1ply.json", "reduced": ["batch_games"],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny1ply.short", "config": "tiny1ply",
                              "traffic": "short", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "test.updates_traced", "unit": "updates",
                              "better": "higher", "source": "program_counter", "layer": "test",
                              "moves": "env_steps_per_s", "workloads": ["tiny1ply.short"]})
    # BENCHMARK.json itself gains entries; every other file is as it was
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}

    files = harness.cell_files("tiny1ply.short", tmp_path)
    assert files.config["batch_games"] == 24 and files.traffic["checked_updates"] == 2
    assert "test.updates_traced" in [m["name"] for m in files.per_layer]
    assert "test.updates_traced" not in [m["name"] for m in
                                         harness.cell_files("prod1ply.train", tmp_path).per_layer]
    import time
    import torch
    out = harness.run("tiny1ply.short", 99, 0.5, True, torch.device("cpu"), time.perf_counter(),
                      root=tmp_path, workers=1)
    assert out["correct"], out["compared"]
    assert out["metrics"]["test.updates_traced"]["value"] >= 1


DRIVER = '''"""A test driver: the closed loop of training, with one more number for
its check to compare."""
from pathlib import Path

from benchmark.loader import load_module

base = load_module(Path(__file__).resolve().parents[2], "drivers", "closed_loop_training")
set_up = base.set_up


def check(*a, **k):
    out = base.check(*a, **k)
    out["compared"].append(("driven_by_test_kind", 0.0, 0.0))
    return out
'''


def test_new_traffic_kind_found_by_its_driver_file(tmp_path):
    _checkout(tmp_path)
    before = _digest(tmp_path)
    b = tmp_path / BENCH.name
    (b / "drivers" / "test_kind.py").write_text(DRIVER)
    mix = json.loads((b / "traffic" / "train.json").read_text())
    mix.update(OVERRIDES["prod1ply.train"]["traffic"], kind="test_kind")
    (b / "traffic" / "other.json").write_text(json.dumps(mix))
    (b / "limits" / "prod1ply.other.json").write_text(
        (b / "limits" / "prod1ply.train.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "prod1ply.other", "config": "prod1ply",
                              "traffic": "other", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    import time
    import torch
    out = harness.run("prod1ply.other", 98, 0.5, False, torch.device("cpu"), time.perf_counter(),
                      root=tmp_path, workers=1,
                      overrides={"config": OVERRIDES["prod1ply.train"]["config"]})
    assert out["correct"], out["compared"]
    assert ("driven_by_test_kind", 0.0, 0.0) in out["compared"]


def test_closed_loop_driver_refuses_a_mode_it_does_not_run():
    import torch

    for train in ({"rollout_mode": "sync"}, {"per_episode_updates": True}):
        conf = json.loads((BENCH / "configs" / "prod1ply.json").read_text())
        conf["train"].update(train)
        with pytest.raises(ValueError, match="driver of its own"):
            harness.driver("closed_loop_training").set_up(
                {**conf, **OVERRIDES["prod1ply.train"]["config"]},
                json.loads((BENCH / "traffic" / "train.json").read_text()), 5,
                torch.device("cpu"), REPO)
