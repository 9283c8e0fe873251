"""The reference's rules work, run in worker processes: each decision's
legal afterstates, and the opponent's replies to a 2-ply candidate.

Workers are plain interpreters started by ``pool_map`` that read one
pickled (function name, jobs) from standard input and write the pickled
results to standard output: pipes only, no shared memory or named
semaphores. This module imports only the rules and NumPy.
"""
from __future__ import annotations

import pickle
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from benchmark.reference import rules

N_CELLS = 52
ROLLS = [(a, b) for a in range(1, 7) for b in range(a, 7)]  # the 21 distinct rolls


def legal(cells, player: int, d0: int, d1: int) -> np.ndarray:
    """int8 [n, 52]: the legal afterstates (reference order)."""
    b = rules.board_from_cells(cells)
    mv = rules.full_moves(b, player, (d0, d1))
    return np.asarray([rules.cells(a) for _, a in mv], np.int8).reshape(-1, N_CELLS)


def replies(cells, opp: int, cap: int) -> Tuple[List[np.ndarray], int]:
    """The opponent's legal replies to a candidate afterstate for each of
    the 21 rolls: non-doubles in reference order, doubles in canonical
    order, the small doubles (die <= 3) cut to their first ``cap``; and the
    count of all legal replies, uncut."""
    b = rules.board_from_cells(cells)
    out, total = [], 0
    for d0, d1 in ROLLS:
        if d0 == d1:
            after = rules.doubles_canonical(b, opp, d0)
            total += len(after)
            if d0 <= 3:
                after = after[:cap]
        else:
            after = [a for _, a in rules.full_moves(b, opp, (d0, d1))]
            total += len(after)
        out.append(np.asarray([rules.cells(a) for a in after], np.int8).reshape(-1, N_CELLS))
    return out, total


FUNCS = {"legal": legal, "replies": replies}


def run_jobs(name: str, jobs: list) -> list:
    return [FUNCS[name](*j) for j in jobs]


def pool_map(name: str, jobs: list, workers: int) -> list:
    """``FUNCS[name]`` over ``jobs`` split into ``workers`` parts, each in a
    worker process (all ended before this returns); in-process at 1."""
    if workers <= 1 or len(jobs) < 2 * workers:
        return run_jobs(name, jobs)
    parts = [jobs[i::workers] for i in range(workers)]
    root = Path(__file__).resolve().parents[2]
    procs = [subprocess.Popen([sys.executable, "-m", "benchmark.reference.jobs"], cwd=root,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE) for _ in parts]
    results: list = [None] * len(parts)

    def talk(i: int) -> None:
        out, _ = procs[i].communicate(pickle.dumps((name, parts[i])))
        results[i] = out

    threads = [threading.Thread(target=talk, args=(i,)) for i in range(len(parts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"a reference worker exited with status {p.returncode}")
    out: list = [None] * len(jobs)
    for i, res in enumerate(results):
        out[i::workers] = pickle.loads(res)
    return out


if __name__ == "__main__":
    fn, part = pickle.loads(sys.stdin.buffer.read())
    sys.stdout.buffer.write(pickle.dumps(run_jobs(fn, part)))
