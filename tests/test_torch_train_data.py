"""The training slice's host side, port against JAX package, on the CPU.

The numpy copies (``correspondence_utils``, ``fourdmatch`` incl. the
augmentation's random stream and the bucket batcher, ``write_4dmatch_suite``,
``AverageMeter``) must be bit-identical to the originals; a checkpoint
written by either package's ``save_pytree`` must load in the other's
``load_pytree`` with equal values; and the two training CLIs' batch
streams must give the same batches on a fabricated suite (arrays bit-equal,
caps equal). No tolerance anywhere in this file: everything is exact.
"""
import dataclasses
import filecmp

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.cli import train_matcher as jcli_m
from deformationpyramid_tpu.cli import train_neco as jcli_n
from deformationpyramid_tpu.data import collate as jcol
from deformationpyramid_tpu.data import correspondence_utils as jcu
from deformationpyramid_tpu.data import fourdmatch as jfd
from deformationpyramid_tpu.data import synthetic as jsyn
from deformationpyramid_tpu.match import backbone as jbb
from deformationpyramid_tpu.utils import checkpoint as jck
from deformationpyramid_tpu.utils import logging as jlog
from deformationpyramid_tpu_torch.cli import train_matcher as tcli_m
from deformationpyramid_tpu_torch.cli import train_neco as tcli_n
from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.data import correspondence_utils as tcu
from deformationpyramid_tpu_torch.data import fourdmatch as tfd
from deformationpyramid_tpu_torch.data import synthetic as tsyn
from deformationpyramid_tpu_torch.match import backbone as tbb
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.utils import checkpoint as tck
from deformationpyramid_tpu_torch.utils import logging as tlog

from tests.test_torch_match_pipeline import landmark_cfgs


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    """The same small 4DMatch-format suite written by each package."""
    roots = {}
    for name, mod in (("jax", jsyn), ("torch", tsyn)):
        root = tmp_path_factory.mktemp(f"suite_{name}")
        for split, n, seed in (("train", 3, 7), ("val", 1, 71)):
            mod.write_4dmatch_suite(str(root), split, n_pairs=n,
                                    size_clusters=(350, 500), seed=seed)
        roots[name] = root
    return roots


@pytest.mark.parametrize("occlusion,rigid", [("uniform", False),
                                             ("coherent", False),
                                             ("uniform", True)])
def test_write_4dmatch_suite_is_bit_identical(tmp_path, occlusion, rigid):
    paths = []
    for name, mod in (("jax", jsyn), ("torch", tsyn)):
        paths.append(mod.write_4dmatch_suite(
            str(tmp_path / name), "train", n_pairs=3, size_clusters=(300, 420),
            seed=5, occlusion=occlusion, rigid=rigid))
    assert len(paths[0]) == len(paths[1]) == 3
    for pj, pt in zip(*paths):
        with np.load(pj) as zj, np.load(pt) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                assert _same(zj[k], zt[k]), k


def test_correspondence_utils_are_bit_identical():
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(300, 3)).astype(np.float32)
    qry = rng.normal(size=(120, 3)).astype(np.float32)
    flow = rng.normal(size=(300, 3)).astype(np.float32) * 0.1
    for k in (1, 3):
        for a, b in zip(jcu.knn_point_np(k, ref, qry),
                        tcu.knn_point_np(k, ref, qry)):
            assert _same(a, b)
    assert _same(jcu.blend_scene_flow(qry, ref, flow),
                 tcu.blend_scene_flow(qry, ref, flow))
    assert _same(jcu.SceneFlowInterp(ref, flow)(qry),
                 tcu.SceneFlowInterp(ref, flow)(qry))
    near = ref[:150] + rng.normal(size=(150, 3)).astype(np.float32) * 0.02
    for radius in (0.05, 0.5):
        cj = jcu.mutual_nn_correspondence(near, ref, search_radius=radius)
        ct = tcu.mutual_nn_correspondence(near, ref, search_radius=radius)
        assert _same(cj, ct)
    assert len(ct) > 10


@pytest.mark.parametrize("augment", [False, True])
def test_fourdmatch_dataset_is_bit_identical(suites, augment):
    """Same files, same ``default_rng(seed)`` stream: equal pairs, the
    augmented ones and a 300-point random cap included."""
    kw = dict(augment=augment, max_points=300, seed=3)
    dj = jfd.FourDMatchDataset(str(suites["jax"]), "train", **kw)
    dt = tfd.FourDMatchDataset(str(suites["torch"]), "train", **kw)
    assert len(dj) == len(dt) == 3
    for i in (0, 1, 2, 1):       # the stream advances with every read
        pj, pt = dj[i], dt[i]
        for f in dataclasses.fields(jfd.Pair):
            a, b = getattr(pj, f.name), getattr(pt, f.name)
            if f.name == "name":
                assert a.split("/")[-1] == b.split("/")[-1]
            elif a is None:
                assert b is None
            else:
                assert _same(a, b), f.name
        assert len(pt.src) <= 300 and len(pt.tgt) <= 300


@pytest.mark.parametrize("square", [False, True])
def test_bucket_batcher_is_bit_identical(suites, square):
    dj = jfd.FourDMatchDataset(str(suites["jax"]), "train")
    dt = tfd.FourDMatchDataset(str(suites["torch"]), "train")
    bj = list(jfd.BucketBatcher(dj, 2, min_bucket=256, square=square))
    bt = list(tfd.BucketBatcher(dt, 2, min_bucket=256, square=square))
    assert len(bj) == len(bt) >= 1
    for a, b in zip(bj, bt):
        for f in dataclasses.fields(jfd.Batch):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert _same(x, y), f.name
            elif f.name != "names":
                assert x == y, f.name


def test_average_meter_is_the_same():
    mj, mt = jlog.AverageMeter(), tlog.AverageMeter()
    for v, n in ((0.5, 1), (2.25, 3), (-1.0, 2)):
        mj.update(v, n)
        mt.update(v, n)
    assert (mj.val, mj.avg, mj.sum, mj.count, mj.std) == (
        mt.val, mt.avg, mt.sum, mt.count, mt.std)


def _tree():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"matcher": {"layers": [{"w": f(3, 4), "b": f(4)},
                                   {"w": f(4, 2), "b": f(2)}],
                        "points": f(5, 3)},
            "neco": {"cls": {"w": f(2, 1)}, "count": np.int32(7)}}


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    tree = _tree()
    path = str(tmp_path / "j.npz")
    jck.save_pytree(path, jax.tree.map(jnp.asarray, tree),
                    meta={"epoch": 3, "loss": 0.25})
    like = tpyr.tree_map(lambda a: torch.zeros(a.shape), tree)
    got = tck.load_pytree(path, like, device="cpu")
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert np.array_equal(a.numpy(), b)
    assert tck.load_meta(path) == {"epoch": 3, "loss": 0.25}
    bad = dict(like, neco={"cls": {"w": torch.zeros(3, 1)},
                           "count": torch.zeros(())})
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_pytree(path, bad)


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    tree = _tree()
    path = str(tmp_path / "t.npz")
    tck.save_pytree(path, tpyr.tree_map(lambda a: torch.from_numpy(
        np.array(a)), tree), meta={"epoch": 1, "loss": 1.5})
    got = jck.load_pytree(path, jax.tree.map(jnp.asarray, tree))
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.array_equal(np.asarray(a), b)
    assert jck.load_meta(path) == {"epoch": 1, "loss": 1.5}
    # and back through the port's own loader, scalars included
    mixed = {"a": [torch.ones(2), None, "x", 3], "b": 0.5}
    tck.save_pytree(str(tmp_path / "m.npz"), mixed)
    back = tck.load_pytree(str(tmp_path / "m.npz"), mixed)
    assert torch.equal(back["a"][0], mixed["a"][0])
    assert back["a"][1:] == [None, "x", 3] and back["b"] == 0.5
    assert tck.load_meta(str(tmp_path / "m.npz")) == {}


def _batches_equal(bj: dict, bt: dict):
    assert set(bj) == set(bt)
    for k in bj:
        if k == "pyramid":
            assert set(bj[k]) == set(bt[k])
            for kk in bj[k]:
                xs, ys = bj[k][kk], bt[k][kk]
                if kk == "features":
                    xs, ys = [xs], [ys]
                assert len(xs) == len(ys)
                for x, y in zip(xs, ys):
                    # the port's index tables are int64 (torch's gathers)
                    assert np.array_equal(np.asarray(x), y.numpy()), (k, kk)
        elif k in ("s_cap", "t_cap"):
            assert bj[k] == bt[k] and isinstance(bt[k], int)
        else:
            x, y = np.asarray(bj[k]), bt[k].numpy()
            assert x.shape == y.shape and np.array_equal(x, y), k
            assert y.dtype.kind == x.dtype.kind


def test_batch_streams_equal_the_jax_clis(suites, monkeypatch):
    # the JAX package's numpy collate (its optional native library orders
    # equidistant neighbours otherwise; the port has the numpy path only)
    monkeypatch.setattr(jcol, "_native", lambda: None)
    jcfg, tcfg = landmark_cfgs(32)
    dj = jfd.FourDMatchDataset(str(suites["jax"]), "train", augment=False)
    dt = tfd.FourDMatchDataset(str(suites["torch"]), "train", augment=False)
    limits = tcol.calibrate_neighborhood_limits(
        [(dt[0].src, dt[0].tgt)], tcfg.matcher.kpfcn, tbb.KPFCN_ARCHITECTURE)
    assert tbb.KPFCN_ARCHITECTURE == jbb.KPFCN_ARCHITECTURE

    sj = jcli_m.make_matcher_batch_stream(dj, jcfg, limits,
                                          coarse_match_radius=0.1)
    st = tcli_m.make_matcher_batch_stream(dt, tcfg, limits,
                                          coarse_match_radius=0.1,
                                          device="cpu")
    bj, bt = list(sj()), list(st())
    assert len(bj) == len(bt) == 3
    for a, b in zip(bj, bt):
        _batches_equal(a, b)
        assert b["s_cap"] == b["t_cap"] == jcli_m._pow2(
            max(int(b["src_len_c"]), int(b["tgt_len_c"])))
        assert bool(b["match_gt_valid"].any())
    assert all(a is b for a, b in zip(bt, st()))      # the cache replays

    # NeCo's stream, on the augmented train split (same random stream)
    dj = jfd.FourDMatchDataset(str(suites["jax"]), "train", augment=True)
    dt = tfd.FourDMatchDataset(str(suites["torch"]), "train", augment=True)
    nj = list(jcli_n.make_batch_stream(dj, jcfg, limits)())
    nt = list(tcli_n.make_batch_stream(dt, tcfg, limits, device="cpu")())
    assert len(nj) == len(nt) == 3
    for a, b in zip(nj, nt):
        _batches_equal(a, b)
    rng = np.random.default_rng(1)
    c, f, fl = (rng.normal(size=s).astype(np.float32)
                for s in ((40, 3), (200, 3), (200, 3)))
    assert _same(jcli_n.interpolate_flow_to_coarse(c, f, fl),
                 tcli_n.interpolate_flow_to_coarse(c, f, fl))


def test_the_suites_are_the_same_files(suites):
    """The fixture's two suites hold equal arrays (npz bytes may differ by
    the zip's timestamps, so compare the contents)."""
    for split, n in (("train", 3), ("val", 1)):
        for i in range(n):
            rel = f"{split}/seq0/pair{i:04d}.npz"
            pj, pt = suites["jax"] / rel, suites["torch"] / rel
            if filecmp.cmp(pj, pt, shallow=False):
                continue
            with np.load(pj) as zj, np.load(pt) as zt:
                assert all(_same(zj[k], zt[k]) for k in zj.files)
