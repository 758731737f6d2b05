"""The port's support utilities: ``utils/seed.py``, ``utils/debug.py``,
``utils/timers.trace`` and ``utils/vis.py`` (its PLY exports byte for byte
against the JAX package's copy; each PNG writer produces a file)."""
import json
import random

import numpy as np
import pytest

import torch

from deformationpyramid_tpu.utils import vis as jvis
from deformationpyramid_tpu_torch.utils import debug, seed, timers
from deformationpyramid_tpu_torch.utils import vis as tvis


def test_setup_seed_seeds_every_generator():
    draws = []
    for _ in range(2):
        gen = seed.setup_seed(11)
        draws.append((np.random.rand(3).tolist(), random.random(),
                      torch.rand(3).tolist(),
                      torch.rand(3, generator=gen).tolist()))
    assert draws[0] == draws[1]
    assert draws[0][3] == torch.rand(
        3, generator=torch.Generator().manual_seed(11)).tolist()
    assert seed.setup_seed(12).initial_seed() == 12


def test_checkified_reports_the_first_non_finite_leaf():
    def fn(x):
        return {"ok": x + 1, "bad": [x, x / 0.0 * 0.0]}, torch.tensor(3)

    err, out = debug.checkified(fn)(torch.ones(2))
    assert torch.equal(out[0]["ok"], torch.full((2,), 2.0))
    assert "['bad'][1]" in err.get()
    with pytest.raises(FloatingPointError, match="non-finite"):
        err.throw()
    err, _ = debug.checkified(lambda x: (x, [x * 2]))(torch.ones(2))
    assert err.get() is None
    err.throw()                   # nothing to raise


def test_enable_nan_checks_switches_anomaly_detection():
    try:
        debug.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_chrome_trace(tmp_path):
    with timers.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0


@pytest.fixture
def scene():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(30, 3)).astype(np.float32)
    nodes = rng.normal(size=(8, 3)).astype(np.float32)
    edges = rng.integers(0, 8, size=(8, 4))
    edges[:, 0] = np.arange(8)            # self-padding, dropped
    tri = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4]])
    return dict(s=s, t=s + 0.05, conf=rng.random(30),
                inl=rng.random(30) < 0.5, nodes=nodes, edges=edges,
                valid=rng.random((8, 4)) < 0.8, tri=tri)


def test_ply_exports_equal_jax_byte_for_byte(scene, tmp_path):
    c = scene
    cases = {
        "corr_conf": lambda m, p: m.export_correspondences_ply(
            p, c["s"], c["t"], confidence=c["conf"]),
        "corr_inl": lambda m, p: m.export_correspondences_ply(
            p, c["s"], c["t"], inlier=c["inl"]),
        "corr_plain": lambda m, p: m.export_correspondences_ply(
            p, c["s"], c["t"]),
        "graph": lambda m, p: m.export_graph_ply(
            p, c["nodes"], c["edges"], edges_valid=c["valid"]),
        "graph_all": lambda m, p: m.export_graph_ply(
            p, c["nodes"], c["edges"]),
        "mesh": lambda m, p: m.export_mesh_ply(p, c["s"], c["tri"]),
        "pcds": lambda m, p: m.export_pcds_ply(
            p, src_pcd=c["s"], tgt_pcd=c["t"], warped_pcd=None, other=c["s"]),
    }
    for name, write in cases.items():
        write(tvis, str(tmp_path / f"t_{name}.ply"))
        write(jvis, str(tmp_path / f"j_{name}.ply"))
        got = (tmp_path / f"t_{name}.ply").read_bytes()
        assert got == (tmp_path / f"j_{name}.ply").read_bytes(), name
        assert got.startswith(b"ply\n")


def test_png_writers_produce_files(scene, tmp_path):
    pytest.importorskip("matplotlib")
    c = scene
    paths = [
        tvis.visualize_pcds(str(tmp_path / "pcds.png"), max_points=20,
                            src_pcd=c["s"], tgt_pcd=c["t"], warped_pcd=None),
        tvis.visualize_correspondences(
            c["s"], c["t"], confidence=c["conf"], src_pcd=c["s"],
            tgt_pcd=c["t"], save_path=str(tmp_path / "corr.png"),
            max_lines=10, max_points=20),
        tvis.visualize_graph(c["nodes"], c["edges"], edges_valid=c["valid"],
                             pcd=c["s"], save_path=str(tmp_path / "g.png"),
                             max_points=20),
        tvis.visualize_mesh(c["s"], c["tri"],
                            save_path=str(tmp_path / "mesh.png")),
    ]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
