"""``bench_torch.py``, the port's twin of ``bench.py``, on the CPU: the
harness at a cut size (two levels of width 32, 20 iterations a level, 64
points: a test of the harness, not a measurement) prints the JSON line on
stdout and the detail on stderr; the routes come from ``bench.py``'s
environment variables; ``--streaming`` runs the continuous-batching solver
and prints its line."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_torch  # noqa: E402
from deformationpyramid_tpu_torch.models.pyramid import NDPConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast as many,
    and parallel test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert cfg.transposed is None
    cfg = bench_torch.make_cfg({"BENCH_FUSED_ITER": "0",
                                "BENCH_FUSED_WARP": "1",
                                "BENCH_FUSED_CD": "1",
                                "BENCH_TRANSPOSED": "1"})
    assert not cfg.use_fused_iteration
    assert cfg.use_fused and cfg.use_fused_chamfer and cfg.transposed
    assert cfg.pyramid.width == 128 and cfg.samples == 2000


def test_bench_cfg_ignores_sweep_reuse():
    """``DP_SWEEP_REUSE`` chooses no route: the bench's config is the same
    with it and without it."""
    assert bench_torch.make_cfg({"DP_SWEEP_REUSE": "4"}) \
        == bench_torch.make_cfg({})


def test_streaming_is_not_ported(monkeypatch, capsys):
    """The name is kept from when ``--streaming`` raised: it now runs
    ``solve/streaming.py`` (here at a cut size) and prints its line."""
    cut = dataclasses.replace(
        bench_torch.CFG, iters=20, samples=64,
        pyramid=NDPConfig(m=2, k0=-8, depth=2, width=32))
    monkeypatch.setattr(bench_torch, "CFG", cut)
    out = bench_torch.main(["--streaming", "--device", "cpu", "--total", "3",
                            "--slots", "2", "--n", "64", "--k-inner", "8"])
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "card"}
    assert line["metric"] == "ndp_registration_throughput"
    assert line["unit"] == "pairs/s" and line["value"] > 0
    assert line["card"] == "cpu"
    detail = json.loads(captured.err.strip().splitlines()[-1])
    assert detail["mode"] == "streaming" and detail["pairs"] == 3
    assert len(detail["epe"]) == 3 and all(
        e < e0 for e, e0 in zip(detail["epe"], detail["initial_epe"]))
    assert out["value"] == line["value"]
