"""``bench_torch.py``, the port's twin of ``bench.py``, on the CPU: the
harness at a cut size (two levels of width 32, 20 iterations a level, 64
points: a test of the harness, not a measurement) prints the JSON line on
stdout and the detail on stderr; the routes come from ``bench.py``'s
environment variables; ``--streaming`` raises, naming what is missing."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
from deformationpyramid_tpu_torch.models.pyramid import NDPConfig  # noqa: E402


def test_main_prints_the_bench_line(monkeypatch, capsys):
    cut = dataclasses.replace(
        bench_torch.CFG, iters=20, samples=64,
        pyramid=NDPConfig(m=2, k0=-8, depth=2, width=32))
    monkeypatch.setattr(bench_torch, "CFG", cut)
    out = bench_torch.main(["--device", "cpu", "--total", "2", "--reps", "2",
                            "--n", "64"])
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "backend"}
    assert line["metric"] == "ndp_registration_throughput"
    assert line["unit"] == "pairs/s" and line["value"] > 0
    assert line["backend"] == "torch-cpu"
    detail = json.loads(captured.err.strip().splitlines()[-1])
    for key in ("ms_per_iteration", "lockstep_iters", "samples_pairs_per_sec",
                "spread"):
        assert key in detail
    assert "mfu_vs_v5e_peak" not in detail
    assert len(detail["samples_pairs_per_sec"]) == 2
    assert 2 <= detail["lockstep_iters"] <= 2 * 2 * 20
    assert out["value"] == line["value"]


def test_routes_follow_the_environment():
    cfg = bench_torch.make_cfg({})
    assert cfg.use_fused_iteration and not cfg.use_fused
    assert cfg.transposed is None and cfg.sweep_reuse is None
    cfg = bench_torch.make_cfg({"BENCH_FUSED_ITER": "0",
                                "BENCH_FUSED_WARP": "1",
                                "BENCH_FUSED_CD": "1",
                                "BENCH_TRANSPOSED": "1",
                                "DP_SWEEP_REUSE": "4"})
    assert not cfg.use_fused_iteration
    assert cfg.use_fused and cfg.use_fused_chamfer and cfg.transposed
    assert cfg.sweep_reuse == 4
    assert cfg.pyramid.width == 128 and cfg.samples == 2000


def test_streaming_is_not_ported():
    with pytest.raises(NotImplementedError, match="solve/streaming.py"):
        bench_torch.main(["--streaming", "--device", "cpu"])
