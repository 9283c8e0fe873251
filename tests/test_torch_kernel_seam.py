"""The one seam of every hand-written kernel (``ops._cuda_build.CudaKernel``)
and the launch registry of the tracer (``utils.profiling``), on the CPU.

* Each of the six kernels launches inside its dispatcher op
  ``mlp_ppo_torch::<name>``: defined once, from a schema whose outputs are
  written in place, with no CPU body.
* The tracer counts, by update, the launches (eager and replayed) of each
  registered kernel that has a counter name, and the plain routes' calls
  on a card; ``trace_summary`` reads them.
* Layering: the tracer imports and looks up no kernel module, the graph
  layer imports nothing from ``ops``, and one file of the package makes
  the launch itself.

The kernels on the card: tests/test_torch_kernel_gpu.py and the other
``*_gpu.py`` files.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.ops import (_cuda_build, dd_expand, fused_value, mlp_value,
                                              stamp, take_rows)
from mlp_ppo_2ply_multi_tpu_torch.utils import profiling as P

PKG = Path(__file__).resolve().parents[1] / "mlp_ppo_2ply_multi_tpu_torch"
MODULES = {"fused_value": fused_value, "nd_tail": nd_tail, "dd_expand": dd_expand,
           "mlp_value": mlp_value, "take_rows": take_rows, "stamp": stamp}
# the outputs each op writes in place
OUTPUTS = {
    "fused_value": ("Tensor(a!) out",),
    "nd_tail": ("Tensor(a!) after", "Tensor(b!) keep", "Tensor(c!) n_pre", "Tensor(d!) pct",
                "Tensor(e!) kpair"),
    "dd_expand": ("Tensor(a!) boards", "Tensor(b!) valid", "Tensor(c!) count",
                  "Tensor(d!) overflow"),
    "mlp_value": ("Tensor(a!) out", "Tensor(b!) count"),
    "take_rows": ("Tensor(a!) out",),
    "stamp": ("Tensor(a!) ring", "Tensor(b!) cursor"),
}
# the update counter of each kernel's launches (the record's names)
COUNTER = {"dd_expand": "dd_kernel_launches", "nd_tail": "nd_tail_kernel_launches",
           "mlp_value": "mlp_kernel_launches"}


@pytest.mark.parametrize("name", list(MODULES))
def test_the_launch_op_is_defined_once_and_for_cuda_alone(name):
    """The kernel launches through the dispatcher op ``mlp_ppo_torch::<name>``
    (so the profiler links it to the scopes around its call): defined at the
    first launch and once, in the package's one library, writing its
    outputs in place, with no CPU body."""
    k = MODULES[name].KERNEL
    op = k.op()
    assert k.op() is op and op is getattr(torch.ops.mlp_ppo_torch, name)
    assert len(_cuda_build._LIBRARY) == 1
    schema = op.default._schema
    assert str(schema).startswith(f"mlp_ppo_torch::{name}(")
    written = [a.name for a in schema.arguments if a.alias_info and a.alias_info.is_write]
    assert written == [o.split()[-1] for o in OUTPUTS[name]]
    assert all(o in str(schema) for o in OUTPUTS[name]), str(schema)
    args = {"Tensor": torch.zeros(1), "int": 1, "List[int]": [1], "bool": False}
    with pytest.raises(NotImplementedError):
        op(*(args[str(a.type)] for a in schema.arguments))


@pytest.mark.parametrize("name", list(MODULES))
def test_launches_counted_by_update(name, monkeypatch):
    """A kernel's launches, eager and replayed, land in the record of the
    update they fell in, under its counter name (0 under the others; a
    kernel without one moves none), and ``trace_summary`` reads them;
    with tracing off the kernel's own count goes on and the tracer keeps
    nothing."""
    k = MODULES[name].KERNEL
    assert k.counter == COUNTER.get(name)
    monkeypatch.setenv(P.TRACE_ENV, "1")
    monkeypatch.setattr(k, "launches", 0)
    P.TRACER.reset()
    held = P.GraphLaunches()
    held.per_replay = {k: 4}  # a chunk graph of four launches
    for update in range(2):
        P.new_update()
        with P.scope("rollout", span=True):
            k.launches += 1  # an eager launch
            for _ in range(3 + update):
                held.replayed()
    P.trace_flush()
    want = lambda n: {c: n if c == k.counter else 0 for c in P.LAUNCH_COUNTERS}
    assert [r["counters"] for r in P.trace_records()] == [want(13), want(17)]
    s = P.trace_summary()
    assert {c: s[f"trace/{c}"] for c in P.LAUNCH_COUNTERS} == want(17.0)
    assert k.launches == 30 and P.kernel_launches()[name] == 30
    monkeypatch.setenv(P.TRACE_ENV, "0")
    P.TRACER.reset()
    held.replayed()
    assert k.launches == 34 and dict(P.TRACER.counters) == {}
    P.TRACER.reset()


def test_a_kernel_loaded_inside_an_update_counts_from_0(monkeypatch, tmp_path):
    monkeypatch.setenv(P.TRACE_ENV, "1")
    monkeypatch.setattr(P, "KERNELS", [])
    P.TRACER.reset()
    P.new_update()
    with P.scope("rollout", span=True):
        k = _cuda_build.CudaKernel(tmp_path / "k.cu", lambda lib: None,
                                   counter="dd_kernel_launches")
        k.launches += 3
    P.trace_flush()
    (rec,) = P.trace_records()
    assert rec["counters"] == {"dd_kernel_launches": 3, "nd_tail_kernel_launches": 0,
                               "mlp_kernel_launches": 0}
    P.TRACER.reset()


@pytest.mark.parametrize("name", ["dd_plain", "nd_tail_plain"])
def test_plain_calls_counted_by_update(name, monkeypatch):
    """The plain doubles chain's and the plain tail's runs on a card
    (``profiling.count``) land in their update's record and in
    ``trace_summary``; with tracing off the tracer keeps nothing."""
    monkeypatch.setenv(P.TRACE_ENV, "1")
    P.TRACER.reset()
    for update in range(2):
        P.new_update()
        with P.scope("rollout", span=True):
            pass
        P.count(name, update)
    P.trace_flush()
    assert [r["counters"].get(name, 0) for r in P.trace_records()] == [0, 1]
    assert P.trace_summary()[f"trace/{name}"] == 1.0
    monkeypatch.setenv(P.TRACE_ENV, "0")
    P.TRACER.reset()
    P.count(name)
    assert dict(P.TRACER.counters) == {}
    P.TRACER.reset()


def _imported(path: Path):
    """Every module ``path`` imports, at any depth of its code, and whether
    it reaches modules by another route (``sys.modules``, ``importlib``,
    ``__import__``)."""
    names, other = [], False
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path.name}: a relative import"
            names += [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Attribute) and node.attr == "modules":
            other = True
        elif isinstance(node, ast.Name) and node.id in ("importlib", "__import__"):
            other = True
    return names, other


@pytest.mark.parametrize("rel, below", [
    ("utils/profiling.py", ("ops", "experimental")),
    ("core/graphs.py", ("ops",)),
])
def test_the_lower_layers_reach_no_kernel_module(rel, below):
    """The tracer imports and looks up no module under ``ops/`` or
    ``experimental/``, and the graph layer imports nothing from ``ops/``:
    the kernels register with them (``profiling.KERNELS``, ``profiling.CLOCK``)."""
    names, other = _imported(PKG / rel)
    banned = tuple(f"mlp_ppo_2ply_multi_tpu_torch.{d}" for d in below)
    assert not [n for n in names if n.startswith(banned)], names
    assert not other


def test_importing_the_graph_layer_loads_no_kernel_module():
    code = ("import sys, mlp_ppo_2ply_multi_tpu_torch.core.graphs\n"
            "print(sorted(m for m in sys.modules if m.startswith(("
            "'mlp_ppo_2ply_multi_tpu_torch.ops', 'mlp_ppo_2ply_multi_tpu_torch.experimental'))))")
    run = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_one_file_of_the_package_makes_the_launch():
    """The dispatcher library, the stream of a launch and the check of a
    launch's return code are ``ops/_cuda_build.py``'s alone."""
    for text in ("torch.library.Library(", ".cuda_stream", "kernel launch failed"):
        where = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                       if text in p.read_text())
        assert where == ["ops/_cuda_build.py"], (text, where)
