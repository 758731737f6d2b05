"""The benchmark's tests run from any directory: the repository's root
goes first on the import path, as ``benchmark/run.py`` puts it."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
