"""``scripts/parity_torch_vs_ledger.py`` on small handmade ledgers: a paired
difference whose 95% t interval holds zero exits 0, one that excludes zero
exits 1, ledgers with other pair names exit 2; the interval is the estimator
of docs/PARITY.md (mean of the paired differences, t quantile at df = n -
1), checked against scipy's own t interval to 1e-12."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
from scipy import stats

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "parity_torch_vs_ledger.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("parity_torch_vs_ledger",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ledger(path, epes, names=None, shift=0.0):
    names = names or [f"data/split/4DMatch-F/seq0/pair{i:04d}.npz"
                      for i in range(len(epes))]
    with open(path, "w") as f:
        for name, e in zip(names, epes):
            row = {k: float(e + shift) for k in ("full-epe", "vis-epe",
                                                  "occ-epe")}
            f.write(json.dumps(dict(row, name=name)) + "\n")
    return str(path)


def test_interval_holding_zero_exits_0(tool, tmp_path, capsys):
    rng = np.random.default_rng(0)
    base = rng.uniform(0.1, 1.0, 12)
    noise = rng.normal(0.0, 0.05, 12)
    a = _ledger(tmp_path / "a.jsonl", base + noise)
    b = _ledger(tmp_path / "b.jsonl", base)
    assert tool.main([a, b, "--pairs", "12"]) == 0
    out = capsys.readouterr().out
    assert "includes zero" in out
    res = json.loads(out.strip().splitlines()[-1])["results"][0]
    lo, hi = stats.t.interval(0.95, 11, loc=noise.mean(),
                              scale=stats.sem(noise))
    assert abs(res["diff"] - noise.mean()) < 1e-12
    assert abs(res["half"] - (hi - lo) / 2) < 1e-12


def test_interval_excluding_zero_exits_1(tool, tmp_path):
    rng = np.random.default_rng(1)
    base = rng.uniform(0.1, 1.0, 12)
    a = _ledger(tmp_path / "a.jsonl", base + rng.normal(0.5, 0.01, 12))
    b = _ledger(tmp_path / "b.jsonl", base)
    assert tool.main([a, b, "--pairs", "12"]) == 1


def test_other_names_fail(tool, tmp_path):
    a = _ledger(tmp_path / "a.jsonl", [0.1, 0.2, 0.3])
    b = _ledger(tmp_path / "b.jsonl", [0.1, 0.2, 0.3],
                names=["x.npz", "y.npz", "z.npz"])
    assert tool.main([a, b, "--pairs", "3"]) == 2
    # the same names, but not the count the run must hold
    c = _ledger(tmp_path / "c.jsonl", [0.1, 0.2, 0.3])
    assert tool.main([a, c]) == 2
