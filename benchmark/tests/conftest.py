"""The benchmark's CPU tests run its harness at small sizes on the CPU."""
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
os.environ.setdefault("OMP_NUM_THREADS", "2")
