"""The port's multiview stack (``match/multiview.py``,
``data/fourdmatch_multiview.py``, ``write_multiview_suite``,
``cli/train_multiview.py``) against the JAX package's, on the CPU.

The same numpy inputs and the JAX init's weights (through
``params_from_numpy``) go through both. Tolerances: the GAT layer, the
multiview NeCo and NonLocalNet 1e-5 absolute on the outputs (confidences
in [0, 1]); one training step's loss 1e-5 and each gradient leaf 1e-4 of
that leaf's largest magnitude; the host-side copies (graph edges, suite
writer, reader, batch maker) bit for bit.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deformationpyramid_tpu.cli import train_multiview as jtm
from deformationpyramid_tpu.data import synthetic as jsyn
from deformationpyramid_tpu.data.fourdmatch_multiview import \
    FourDMatchMultiview as JMV
from deformationpyramid_tpu.match import losses as jlosses
from deformationpyramid_tpu.match import multiview as jmv
from deformationpyramid_tpu.match.outlier_rejection import \
    NeCoConfig as JNeCoConfig
from deformationpyramid_tpu_torch.cli import train_multiview as ttm
from deformationpyramid_tpu_torch.data import synthetic as tsyn
from deformationpyramid_tpu_torch.data.fourdmatch_multiview import \
    FourDMatchMultiview as TMV
from deformationpyramid_tpu_torch.match import multiview as tmv
from deformationpyramid_tpu_torch.match.outlier_rejection import \
    NeCoConfig as TNeCoConfig
from deformationpyramid_tpu_torch.models.pyramid import (params_from_numpy,
                                                         tree_map)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _close(t, j, tol=TOL):
    t = t.detach().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape
    err = float(np.abs(t - j).max()) if t.size else 0.0
    assert err <= tol, err


def _cfgs(fd=48, heads=4, layers=2):
    return (jmv.MultiviewNeCoConfig(neco=JNeCoConfig(
                feature_dim=fd, n_head=heads, num_layers=layers)),
            tmv.MultiviewNeCoConfig(neco=TNeCoConfig(
                feature_dim=fd, n_head=heads, num_layers=layers)))


def _edges(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("case", ["star", "random_half_masked"])
def test_gat_layer_matches_jax(case):
    jcfg, tcfg = jmv.GATConfig(16, 4), tmv.GATConfig(16, 4)
    jp = jmv.init_gat_layer(jax.random.key(0), jcfg)
    tp = _to_torch(jp)
    rng = np.random.default_rng(0)
    if case == "star":        # tests/test_multiview.py's graph: 1..5 -> 0
        feat = rng.normal(size=(6, 16)).astype(np.float32)
        es, et = np.arange(1, 6), np.zeros(5, np.int64)
        ev = np.ones(5, bool)
    else:
        feat = rng.normal(size=(20, 16)).astype(np.float32)
        es, et = rng.integers(0, 20, 64), rng.integers(0, 20, 64)
        ev = rng.random(64) < 0.5
    jout = jmv.apply_gat_layer(jp, jnp.array(feat), jnp.array(es),
                               jnp.array(et), jnp.array(ev), jcfg)
    tout = tmv.apply_gat_layer(tp, torch.from_numpy(feat),
                               *_edges(es, et, ev), tcfg)
    _close(tout, jout)
    # a node with no valid in-edge gets the bias alone
    no_in = np.setdiff1d(np.arange(len(feat)), et[ev])
    assert len(no_in) > 0
    assert torch.equal(tout[no_in], tp["bias"].expand(len(no_in), -1))


def test_gat_layer_all_edges_masked_gives_the_bias():
    tcfg = tmv.GATConfig(16, 4)
    tp = _to_torch(jmv.init_gat_layer(jax.random.key(1),
                                      jmv.GATConfig(16, 4)))
    feat = torch.randn(6, 16, generator=torch.Generator().manual_seed(0))
    out = tmv.apply_gat_layer(tp, feat, *_edges(
        np.arange(1, 6), np.zeros(5, np.int64), np.zeros(5, bool)), tcfg)
    assert torch.equal(out, tp["bias"].expand(6, -1))


def _graph_case(seed, n_pairs=3, k=16):
    rng = np.random.default_rng(seed)
    vec6d = (rng.normal(size=(n_pairs, k, 6)) * 0.1).astype(np.float32)
    mask = rng.random((n_pairs, k)) < 0.8
    pairs = np.array([[0, 1], [0, 2], [1, 2]])[:n_pairs]
    return vec6d, mask, pairs


@pytest.mark.parametrize("max_edges", [4096, 37])
def test_build_correspondence_graph_bit_equal(max_edges):
    vec6d, mask, pairs = _graph_case(3)
    full = jmv.build_correspondence_graph(vec6d, mask, pairs, 0.1, 4096)
    n_full = int(full[2].sum())
    j = jmv.build_correspondence_graph(vec6d, mask, pairs, 0.1, max_edges)
    t = tmv.build_correspondence_graph(vec6d, mask, pairs, 0.1, max_edges)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if max_edges < n_full:
        # the silent cut: the first max_edges edges of the uncut list
        assert t[2].all()
        assert np.array_equal(t[0], full[0][:max_edges])
        assert np.array_equal(t[1], full[1][:max_edges])
    else:
        assert int(t[2].sum()) == n_full > 37


def test_multiview_neco_matches_jax():
    jcfg, tcfg = _cfgs()
    jp = jmv.init_multiview_neco(jax.random.key(0), jcfg)
    tp = _to_torch(jp)
    vec6d, mask, pairs = _graph_case(5)
    es, et, ev = jmv.build_correspondence_graph(vec6d, mask, pairs, 0.1, 2048)
    assert ev.sum() > 0
    jconf = jmv.apply_multiview_neco(
        jp, jnp.array(vec6d), jnp.array(mask), jnp.array(es), jnp.array(et),
        jnp.array(ev), jcfg)
    tconf = tmv.apply_multiview_neco(
        tp, torch.from_numpy(vec6d), torch.from_numpy(mask),
        *_edges(es, et, ev), tcfg)
    assert tconf.shape == (3, 16)
    _close(tconf, jconf)
    assert (tconf[~torch.from_numpy(mask)] == 0).all()


def test_nonlocalnet_matches_jax():
    jcfg = jmv.NonLocalNetConfig(num_layers=2, num_channels=32)
    tcfg = tmv.NonLocalNetConfig(num_layers=2, num_channels=32)
    jp = jmv.init_nonlocalnet(jax.random.key(0), jcfg)
    tp = _to_torch(jp)
    rng = np.random.default_rng(2)
    vec6d = (rng.normal(size=(20, 6)) * 0.1).astype(np.float32)
    mask = np.arange(20) < 16
    jconf = jmv.apply_nonlocalnet(jp, jnp.array(vec6d), jnp.array(mask), jcfg)
    tconf = tmv.apply_nonlocalnet(tp, torch.from_numpy(vec6d),
                                  torch.from_numpy(mask), tcfg)
    _close(tconf, jconf)
    assert (tconf[16:] == 0).all()


def test_init_shapes_match_jax():
    jcfg, tcfg = _cfgs()
    jshapes = jax.tree.map(np.shape, jmv.init_multiview_neco(
        jax.random.key(0), jcfg))
    tshapes = tree_map(lambda t: tuple(t.shape), tmv.init_multiview_neco(
        torch.Generator().manual_seed(0), tcfg))
    assert tshapes == jshapes
    jshapes = jax.tree.map(np.shape, jmv.init_nonlocalnet(jax.random.key(0)))
    tshapes = tree_map(lambda t: tuple(t.shape), tmv.init_nonlocalnet(
        torch.Generator().manual_seed(0)))
    assert tshapes == jshapes


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mv")
    kw = dict(n_seqs=2, n_views=3, n_pts=120, seed=1)
    jpaths = jsyn.write_multiview_suite(str(tmp / "jax"), "multiview-train",
                                        **kw)
    tpaths = tsyn.write_multiview_suite(str(tmp / "torch"),
                                        "multiview-train", **kw)
    return dict(tmp=tmp, jpaths=jpaths, tpaths=tpaths)


def test_write_multiview_suite_arrays_bit_equal(suites):
    assert len(suites["tpaths"]) == len(suites["jpaths"]) == 2
    for tp, jp in zip(suites["tpaths"], suites["jpaths"]):
        assert tp.split("torch")[-1] == jp.split("jax")[-1]
        with np.load(tp) as t, np.load(jp) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in j.files:
                assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])


def test_multiview_reader_samples_bit_equal(suites, tmp_path):
    # a sequence whose pair (0, 2) the overlap threshold drops
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "seq0.npz",
             pcds=rng.normal(size=(3, 50, 3)).astype(np.float32),
             pcd_pairs=np.array([[0, 1], [0, 2], [1, 2]]),
             pairwise_flows=rng.normal(size=(3, 50, 3)).astype(np.float32),
             pairwise_overlap=np.array([[0.9, 0.8], [0.2, 0.9], [0.7, 0.6]]),
             poses=np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)))
    for root, split in ((str(suites["tmp"] / "torch"), "multiview-train"),
                        (str(tmp_path), ".")):
        jds, tds = JMV(root, split), TMV(root, split)
        assert tds.entries == jds.entries and len(tds) > 0
        for i in range(len(tds)):
            for _ in range(2):       # the second read comes from the cache
                t, j = tds[i], jds[i]
                for f in ("pcds", "pcd_pairs", "pairwise_flows",
                          "pairwise_overlap", "axis_flow", "axis_node",
                          "poses"):
                    a, b = getattr(t, f), getattr(j, f)
                    assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert len(TMV(str(tmp_path), ".")[0].pcd_pairs) == 2


def test_make_training_batch_bit_equal(suites):
    ds = TMV(str(suites["tmp"] / "torch"), "multiview-train")
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(len(ds)):
        for k, max_pairs in ((24, 6), (200, 4)):   # k beyond the cloud too
            j = jtm.make_training_batch(ds[i], k, 0.4, max_pairs, 2048, jrng,
                                        0.1)
            t = ttm.make_training_batch(ds[i], k, 0.4, max_pairs, 2048, trng,
                                        0.1)
            for a, b in zip(t, j):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_training_step_matches_jax(suites):
    """One step: the loss and IR info (1e-5), the gradients (1e-4 of each
    leaf's max) against jax.value_and_grad, and the Adam update of the CLI
    against optax.adam's (1e-6)."""
    jcfg, tcfg = _cfgs()
    ds = TMV(str(suites["tmp"] / "torch"), "multiview-train")
    batch = ttm.make_training_batch(ds[0], 24, 0.4, 6, 2048,
                                    np.random.default_rng(0), 0.1)
    jp = jmv.init_multiview_neco(jax.random.key(3), jcfg)
    tp = _to_torch(jp)

    def jloss(p):
        conf = jmv.apply_multiview_neco(p, *[jnp.array(batch[i]) for i in
                                             (0, 1)],
                                        *[jnp.array(batch[i]) for i in
                                          (3, 4, 5)], jcfg)
        return jlosses.balanced_bce(conf, jnp.array(batch[2]),
                                    jnp.array(batch[1]))

    jl, jg = jax.value_and_grad(jloss)(jp)
    tb = [torch.from_numpy(x) for x in batch]
    (tl, info), tg = ttm.value_and_grad(
        lambda p: ttm.multiview_loss(p, *tb, tcfg), tp)
    assert abs(float(tl) - float(jl)) <= TOL
    labels, mask = batch[2], batch[1]
    assert float(info["IR_before"]) == pytest.approx(
        (labels & mask).sum() / mask.sum(), abs=1e-7)
    worst = []

    def check(t, j):
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1e-12)
        worst.append(float(np.abs(t.numpy() - j).max()) / scale)

    tree_map(check, tg, jax.tree.map(np.asarray, jg))
    assert len(worst) == len(jax.tree.leaves(jg)) and max(worst) <= 1e-4, \
        max(worst)

    opt = optax.adam(1e-3)
    upd, _ = opt.update(jg, opt.init(jp), jp)
    jnew = optax.apply_updates(jp, upd)
    topt = ttm.adam(1e-3)
    step = ttm.make_train_step(tcfg, topt)
    tnew, _, tl2, _ = step(tp, topt.init(tp), *tb)
    assert float(tl2) == float(tl)

    # Adam's first step moves a weight by ~lr * sign(g): where a gradient
    # entry is ~0 the two gradients' small differences may change it
    def check_step(t, j, g):
        t, j, g = t.numpy(), np.asarray(j), np.abs(np.asarray(g))
        sure = g > 1e-3 * max(float(g.max()), 1e-12)
        assert np.abs(t - j)[sure].max(initial=0.0) <= 1e-6
        assert np.abs(t - j).max(initial=0.0) <= 2e-3 + 1e-6

    tree_map(check_step, tnew, jax.tree.map(np.asarray, jnew),
             jax.tree.map(np.asarray, jg))


def test_train_multiview_cli_end_to_end(suites, tmp_path):
    """The port's CLI at the JAX test's tiny settings
    (tests/test_multiview.py) with that test's gates: the loss falls, the
    post-filter inlier ratio beats the planted one, the checkpoints are
    written (and read back bit-equal)."""
    from deformationpyramid_tpu_torch.utils.checkpoint import load_pytree

    root = str(suites["tmp"] / "torch")
    snap = tmp_path / "snap"
    rows = ttm.main(["--data-root", root, "--epochs", "6", "--k", "24",
                     "--max-pairs", "6", "--max-edges", "2048",
                     "--feature-dim", "48", "--num-layers", "2",
                     "--snapshot-dir", str(snap), "--device", "cpu"])
    hist = [json.loads(l) for l in
            (snap / "history.jsonl").read_text().splitlines()]
    assert [{k: r[k] for k in h} for r, h in zip(rows, hist)] == hist
    assert set(hist[0]) == {"epoch", "loss", "IR_before", "IR_after"}
    assert hist[-1]["loss"] < hist[0]["loss"], hist
    assert hist[-1]["IR_after"] > hist[-1]["IR_before"], hist[-1]
    assert all(r["seconds"] > 0 and r["step_ms"] > 0 for r in rows)
    like = tmv.init_multiview_neco(  # the CLI's config: 8 heads of 6
        torch.Generator().manual_seed(9), tmv.MultiviewNeCoConfig(
            neco=TNeCoConfig(feature_dim=48, num_layers=2)))
    for name in ("model_best_loss.npz", "model_last.npz"):
        back = load_pytree(str(snap / name), like)
        assert tree_map(lambda t: t.shape, back) == tree_map(
            lambda t: t.shape, like)
