"""The runner fails, and prints no result, rather than fall back: without a
card, and in a checkout that holds only ``BENCHMARK.json`` and the
benchmark's own files."""
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
ARGS = ["--workload", "prod1ply.train", "--seed", "3000000001", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and r.stdout.strip() == "", (r.returncode, r.stdout, r.stderr)
    assert "CUDA" in r.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    # a card is claimed, so the run goes on to look for the program
    boot = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            f"sys.argv = ['benchmark.run', *{ARGS!r}]\n"
            "runpy.run_module('benchmark.run', run_name='__main__')\n")
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", boot], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 3 and r.stdout.strip() == "", (r.returncode, r.stdout, r.stderr)
