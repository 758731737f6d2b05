"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. Exits with 2 and prints no result where
there is no card (or fewer than the cell asks for), and with 1 where the
port cannot be imported or the run loaded JAX.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# A library that the port uses may load JAX by itself where it finds it.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main())
