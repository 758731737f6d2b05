"""The port's Sim(3) shape-transfer path against the JAX package's, on the
CPU: the copied PLY module bit-identical to the original, and
``register_meshes`` (Sim3 + euler, every level on all the samples) against
the JAX package's level scan as its ``register_meshes`` builds it
(``cli/shape_transfer.py:67-86``), from the same initial weights. Per-level
iterations equal, level losses within 1e-4 and the warped vertices within
1e-3 (the bound of tests/test_torch_registration.py for a whole solve).
The JAX kernels run in Pallas interpret mode with the pins of
tests/test_fused_iteration.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deformationpyramid_tpu.data import ply as jply
from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.ops import fused_iteration as jfi
from deformationpyramid_tpu.ops import fused_level as jfl
from deformationpyramid_tpu.solve import registration as jreg
from deformationpyramid_tpu_torch.cli import shape_transfer as tst
from deformationpyramid_tpu_torch.data import ply as tply
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.solve import registration as treg

PYR = dict(m=3, k0=-6, depth=3, width=64, rotation_format="euler",
           motion="Sim3")
SOLVE = dict(iters=30, lr=0.01, max_break_count=15,
             break_threshold_ratio=0.001, samples=240)


@pytest.fixture(autouse=True)
def _exact_jax_kernels():
    """The pins of tests/test_fused_iteration.py for the JAX fused path."""
    prev = (jfl._WIDE_MODE, jfi._SWEEP_MXU_DIST, jfi._SWEEP_PACKED)
    jfl._WIDE_MODE = "highest"
    jfi._SWEEP_MXU_DIST = False
    jfi._SWEEP_PACKED = False
    try:
        yield
    finally:
        jfl._WIDE_MODE, jfi._SWEEP_MXU_DIST, jfi._SWEEP_PACKED = prev


def _sheet(nx=14, ny=12):
    """A wavy triangulated sheet: vertices [nx*ny, 3], faces [F, 3]."""
    u, v = np.meshgrid(np.linspace(-0.6, 0.6, nx), np.linspace(-0.5, 0.5, ny),
                       indexing="ij")
    verts = np.stack([u, v, 0.15 * np.sin(3 * u) * np.cos(2 * v)], -1)
    idx = np.arange(nx * ny).reshape(nx, ny)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, d], -1), np.stack([a, d, c], -1)])
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int32)


def _target(verts):
    """A Sim3 transform of the sheet plus a smooth bend."""
    ang = 0.2
    rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                    [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    bent = verts + np.stack([np.zeros(len(verts)), np.zeros(len(verts)),
                             0.1 * verts[:, 0] ** 2], -1)
    return (1.1 * bent @ rot.T + [0.05, -0.02, 0.03]).astype(np.float32)


def test_ply_copy_bit_identical(tmp_path):
    verts, faces = _sheet()
    paths = [tmp_path / "jax.ply", tmp_path / "port.ply"]
    jply.save_ply(str(paths[0]), verts, faces)
    tply.save_ply(str(paths[1]), verts, faces)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    # a binary little-endian file with normals and an extra property
    rec = np.zeros(len(verts), dtype=[("x", "<f4"), ("y", "<f4"),
                                      ("z", "<f4"), ("nx", "<f4"),
                                      ("ny", "<f4"), ("nz", "<f4"),
                                      ("red", "u1")])
    for i, c in enumerate(("x", "y", "z", "nx", "ny", "nz")):
        rec[c] = verts[:, i % 3] * (1 + i)
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex "
            f"{len(verts)}\nproperty float x\nproperty float y\n"
            "property float z\nproperty float nx\nproperty float ny\n"
            "property float nz\nproperty uchar red\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    body = b"".join(np.uint8(3).tobytes() + f.astype("<i4").tobytes()
                    for f in faces)
    binary = tmp_path / "bin.ply"
    binary.write_bytes(head.encode() + rec.tobytes() + body)
    for path in (*paths, binary):
        a, b = jply.load_ply(str(path)), tply.load_ply(str(path))
        for k in ("vertices", "faces", "normals"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None and y is None) or (
                x.dtype == y.dtype and np.array_equal(x, y)), (path, k)
    mesh_j, mesh_t = jply.load_ply(str(binary)), tply.load_ply(str(binary))
    for seed in (0, 1):
        assert np.array_equal(jply.sample_points_uniformly(mesh_j, 500, seed),
                              tply.sample_points_uniformly(mesh_t, 500, seed))
    no_faces = tply.PlyMesh(vertices=verts, faces=None)
    assert np.array_equal(
        jply.sample_points_uniformly(jply.PlyMesh(verts, None), 50, 3),
        tply.sample_points_uniformly(no_faces, 50, 3))


@pytest.mark.parametrize("fused", [False, True])
def test_register_meshes_matches_jax(fused):
    verts, faces = _sheet()
    mesh_s = tply.PlyMesh(verts, faces)
    mesh_t = tply.PlyMesh(_target(verts), faces)
    n = SOLVE["samples"]
    src_pts = tply.sample_points_uniformly(mesh_s, n, seed=0)
    tgt_pts = tply.sample_points_uniformly(mesh_t, n, seed=1)
    jcfg = jreg.SolverConfig(pyramid=jpyr.NDPConfig(**PYR), **SOLVE,
                             use_pallas=False, use_fused_iteration=fused)
    tcfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR), **SOLVE,
                             use_fused_iteration=fused)
    key = jax.random.key(3)

    @jax.jit
    def jax_run(params, src, tgt, vs):
        # deformationpyramid_tpu/cli/shape_transfer.py:68-86, the initial
        # params given
        src_mean = jnp.mean(src, axis=0, keepdims=True)
        tgt_mean = jnp.mean(tgt, axis=0, keepdims=True)
        src_c, tgt_c = src - src_mean, tgt - tgt_mean
        valid_n = jnp.ones((src.shape[0],), bool)
        valid_m = jnp.ones((tgt.shape[0],), bool)

        def level_step(pts, inp):
            lvl_p, lvl = inp
            new_p, warped, stats = jreg._solve_level(
                lvl_p, lvl, pts, valid_n, tgt_c, valid_m, 0, None, None,
                jcfg)
            return warped, (new_p, stats)

        levels = jnp.arange(jcfg.pyramid.m)
        _, (final, stats) = jax.lax.scan(level_step, src_c, (params, levels))
        warped, _ = jpyr.warp(final, vs - src_mean, jcfg.pyramid)
        return warped + tgt_mean, stats

    init = jax.jit(jpyr.init_pyramid_params, static_argnums=1)(
        key, jcfg.pyramid)
    jwarped, jstats = jax_run(init, *map(jnp.asarray,
                                         (src_pts, tgt_pts, verts)))
    twarped, tstats = tst.register_meshes(
        src_pts, tgt_pts, verts, tcfg, device="cpu",
        params=tpyr.params_from_numpy(jax.tree.map(np.asarray, init)))
    assert tstats["iters"].tolist() == np.asarray(jstats["iters"]).tolist()
    assert np.abs(tstats["loss"].numpy() - np.asarray(jstats["loss"])
                  ).max() < 1e-4
    assert np.abs(twarped.numpy() - np.asarray(jwarped)).max() < 1e-3


def test_shape_transfer_main_writes_warped_mesh(tmp_path, monkeypatch,
                                                capsys):
    """The CLI end to end on the CPU at a small configuration: PLY in,
    warped PLY out with the source's faces, the warp moved toward the
    target."""
    verts, faces = _sheet()
    tgt = _target(verts)
    tply.save_ply(str(tmp_path / "s.ply"), verts, faces)
    tply.save_ply(str(tmp_path / "t.ply"), tgt, faces)
    monkeypatch.setattr(tst, "DEMO_CFG", treg.SolverConfig(
        pyramid=tpyr.NDPConfig(**PYR), **SOLVE))
    tst.main(["-s", str(tmp_path / "s.ply"), "-t", str(tmp_path / "t.ply"),
              "-o", str(tmp_path / "o.ply"), "--samples", "200",
              "--device", "cpu"])
    assert "iters/level" in capsys.readouterr().out
    out = tply.load_ply(str(tmp_path / "o.ply"))
    assert out.vertices.shape == verts.shape
    assert np.array_equal(out.faces, faces)
    assert np.isfinite(out.vertices).all()
    before = np.abs(verts - tgt).mean()
    after = np.abs(out.vertices - tgt).mean()
    assert after < 0.5 * before


def test_default_device_is_cuda(monkeypatch):
    """The entry points run on the card unless the caller asks for the CPU:
    ``register_meshes`` defaults to ``cuda`` and so does the CLI's
    ``--device``, with no fallback to the CPU when there is no GPU."""
    import inspect
    from types import SimpleNamespace

    import torch

    assert inspect.signature(tst.register_meshes).parameters[
        "device"].default == "cuda"
    seen = {}
    mesh = SimpleNamespace(vertices=np.zeros((4, 3), np.float32),
                           faces=np.zeros((1, 3), np.int32))

    def fake_register(src, tgt, verts, cfg, seed, device):
        seen["device"] = device
        return torch.zeros(4, 3), {"iters": torch.ones(9),
                                   "loss": torch.zeros(9)}

    monkeypatch.setattr(tst, "load_ply", lambda path: mesh)
    monkeypatch.setattr(tst, "sample_points_uniformly",
                        lambda m, n, seed: np.zeros((n, 3), np.float32))
    monkeypatch.setattr(tst, "register_meshes", fake_register)
    tst.main(["-s", "a.ply", "-t", "b.ply"])
    assert seen["device"] == "cuda"
