"""Loads a file of the benchmark by the name ``BENCHMARK.json`` or a
configuration gives it: ``<root>/benchmark/<folder>/<name>.py``, so that a
cell that adds such a file runs with no edit to a file already there."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

FOLDER = Path(__file__).resolve().parent.name


def load_module(root: Path, folder: str, name: str) -> ModuleType:
    """The module ``<root>/benchmark/<folder>/<name>.py``, loaded from its
    file under a name of its own."""
    path = Path(root) / FOLDER / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"benchmark: no {folder} file {path.name} under {path.parent}")
    spec = importlib.util.spec_from_file_location(
        f"_benchmark_{folder}_{name.replace('.', '_')}_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
