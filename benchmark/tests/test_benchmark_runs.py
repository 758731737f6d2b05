"""Whole runs of each cell at a size the CPU holds: the harness's look for
a card is skipped (``device=cpu``), the rest of a run is driven, and
``correct`` comes out true, and false with the timed path broken
underneath. The controls (the reference one precision below float32 in
the program's place) need the card's TF32 and run there, at the cells'
sizes, through the ``cuda``-marked test."""
import os
import subprocess
import sys

import pytest
import torch

from benchmark import core

CPU = torch.device("cpu")
SMALL = {
    "lndp.4dmatch": dict(
        traffic_overrides=dict(clusters=[400, 700], per_cluster=1,
                               calibrate=2),
        config_overrides=dict(m=2, iters=30, num_workers=2)),
    "lndp.train": dict(
        traffic_overrides=dict(pairs=4, size=500, collate_threads=2)),
}


def small_run(cell, seed=2**31 + 11, seconds=2.0):
    return core.run_cell(cell, seed, seconds, False, device=CPU,
                         **SMALL[cell])


def test_no_card_no_result(tmp_path):
    """Without a card the run exits with 2 and prints no result; so it does
    in a directory that holds only BENCHMARK.json and the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure it")
    for cwd in (core.ROOT, tmp_path):
        if cwd == tmp_path:
            subprocess.run(["cp", "-r", str(core.BENCH),
                            str(core.ROOT / "BENCHMARK.json"), str(tmp_path)],
                           check=True)
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "lndp.train",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, BENCH_RUN="1"))
        assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    result = small_run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["metrics"]["setup_s"]["value"] > 0


def _lndp_fault(name, registration):
    """The timed path broken underneath: the answer altered where it is
    produced, or a level's state returned unchanged (every level; every
    level after the first; every level of the larger cluster's pairs)."""
    register, solve_level = registration.register_pair, \
        registration._solve_level
    if name == "answer_altered":
        def altered(*a, **kw):
            warped, stats = register(*a, **kw)
            return warped + 1.0, stats
        return {"register_pair": altered}
    larger = [False]

    def pair(*a, **kw):
        larger[0] = int(kw["src_valid"].sum()) > 550
        return register(*a, **kw)

    def frozen(lvl_params, lvl, pts, *a, **kw):
        new, aux, stats = solve_level(lvl_params, lvl, pts, *a, **kw)
        hit = {"unchanged": True, "unchanged_after_level_0": lvl >= 1,
               "unchanged_in_one_cluster": larger[0]}[name]
        return (lvl_params if hit else new), aux, stats
    return {"register_pair": pair, "_solve_level": frozen}


@pytest.mark.parametrize("fault", ["answer_altered", "unchanged",
                                   "unchanged_after_level_0",
                                   "unchanged_in_one_cluster"])
def test_lndp_faults_are_caught(fault, monkeypatch):
    from deformationpyramid_tpu_torch.solve import registration
    for name, fn in _lndp_fault(fault, registration).items():
        monkeypatch.setattr(registration, name, fn)
    assert not small_run("lndp.4dmatch")["correct"]


def test_train_fault_is_caught(monkeypatch):
    from deformationpyramid_tpu_torch.train import trainer
    make = trainer.make_matcher_train_step

    def unchanged(*a, **kw):
        step = make(*a, **kw)

        def bad(params, state, *rest):
            _, _, loss, info, ok = step(params, state, *rest)
            return params, state, loss, info, ok
        return bad
    monkeypatch.setattr(trainer, "make_matcher_train_step", unchanged)
    assert not small_run("lndp.train")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_on_the_card(cell):
    """The control at the cell's own size, on three seeds: each run reads
    ``correct`` false (its numbers are in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products run on the card")
    seconds = {"lndp.4dmatch": 8.0, "lndp.train": 3.0}[cell]
    for seed in (101, 2**31 + 3, 7_000_000_001):
        result = core.run_cell(cell, seed, seconds, False, control="tf32")
        assert not result["correct"], result["checks"]
