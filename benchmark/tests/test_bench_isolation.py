"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.run import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
PROGRAM = "mlp_ppo_2ply_multi_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts[len(BENCH.parts):])


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_imports(path)) and not set(_imports(path)) & FORBIDDEN


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_process_holds_no_program():
    mods = _modules_after("import benchmark.reference.td_selfplay")
    assert PROGRAM not in mods and not mods & FORBIDDEN


def test_run_process_holds_no_jax():
    mods = _modules_after(
        "import benchmark.run, benchmark.harness, benchmark.trace, benchmark.yardstick\n"
        "import mlp_ppo_2ply_multi_tpu_torch.actor.rollout, mlp_ppo_2ply_multi_tpu_torch.learner.td\n"
        "from benchmark import harness\n"
        "spec = harness.load_json(harness.REPO / 'BENCHMARK.json')\n"
        "[harness.metric_reader(m['name']) for m in spec['per_layer']]\n"
        "[harness.driver(p.stem) for p in (harness.HERE / 'drivers').glob('*.py')]")
    assert PROGRAM in mods and not mods & FORBIDDEN


def test_forbidden_names_compared_whole(monkeypatch):
    base = forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, PROGRAM, sys)
    monkeypatch.setitem(sys.modules, PROGRAM + ".core", sys)
    assert forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "mlp_ppo_2ply_multi_tpu.core", sys)
    assert "mlp_ppo_2ply_multi_tpu" in forbidden_modules()
