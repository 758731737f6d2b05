"""The port's checkpoint converter (``match/port_torch.py``) against the JAX
package's: the synthetic reference-layout state dicts of
``tests/test_port_torch.py`` go through both ``port_matcher`` /
``port_neco``; the ported trees are equal leaf for leaf (bit for bit) and
the reports (used / missing / unused names) are equal."""
import numpy as np
import pytest

import jax
import torch

from deformationpyramid_tpu.match import port_torch as jport
from deformationpyramid_tpu.match.outlier_rejection import NeCoConfig, init_neco
from deformationpyramid_tpu.match.pipeline import init_matcher
from deformationpyramid_tpu_torch.match import port_torch as tport
from deformationpyramid_tpu_torch.models.pyramid import (params_from_numpy,
                                                         tree_leaves,
                                                         tree_map)

from test_port_torch import FD, small_cfg, synth_attention_sd


def matcher_state_dict(params, cfg, rng, drop=()):
    """A reference ``Pipeline`` state dict with a name for every leaf of
    ``params`` and the dead ``tgt_proj`` weights, less the names in
    ``drop``."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    sd = {}
    for i, blk in enumerate(params["backbone"]["encoder"]):
        pfx = f"backbone.encoder_blocks.{i}"
        sd[f"{pfx}.KPConv.weights"] = f32(*np.shape(blk["kpconv"]["weights"]))
        sd[f"{pfx}.KPConv.kernel_points"] = f32(
            *np.shape(blk["kpconv"]["kernel_points"]))
        for ours, theirs in (("unary1", "unary1"), ("unary2", "unary2"),
                             ("shortcut", "unary_shortcut")):
            if ours in blk:
                w = np.shape(blk[ours]["w"])
                sd[f"{pfx}.{theirs}.mlp.weight"] = f32(w[1], w[0])
    for i, blk in enumerate(params["backbone"]["decoder"]):
        if blk:
            w = np.shape(blk["w"])
            sd[f"backbone.decoder_blocks.{i}.mlp.weight"] = f32(w[1], w[0])
    for name in ("coarse_out", "fine_out"):
        w = np.shape(params["backbone"][name]["w"])
        sd[f"backbone.{name}.weight"] = f32(w[1], w[0], 1)
        sd[f"backbone.{name}.bias"] = f32(w[1])
    for i, lt in enumerate(cfg.transformer.layer_types):
        pfx = f"coarse_transformer.layers.{i}"
        if lt in ("self", "cross"):
            sd.update(synth_attention_sd(pfx, FD, rng))
        else:
            sd[f"{pfx}.0.src_proj.weight"] = f32(FD, FD)
            sd[f"{pfx}.0.tgt_proj.weight"] = f32(FD, FD)
    sd["coarse_matching.src_proj.weight"] = f32(FD, FD)
    sd["coarse_matching.tgt_proj.weight"] = f32(FD, FD)
    return {k: v for k, v in sd.items() if k not in drop}


def neco_state_dict(rng, d=48, layers=2):
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    sd = {"in_proj.weight": f32(d, 6), "in_proj.bias": f32(d),
          "extra.buffer": f32(3)}
    for i in range(layers):
        sd.update(synth_attention_sd(f"_6D_geometry_layers.{i}", d, rng))
    for name, (i_d, o_d) in (("classification.0", (d, 64)),
                             ("classification.2", (64, 32)),
                             ("classification.4", (32, 1))):
        sd[f"{name}.weight"] = f32(o_d, i_d)
        sd[f"{name}.bias"] = f32(o_d)
    return sd


def _assert_same(ttree, jtree):
    jnp_tree = jax.tree.map(np.asarray, jtree)
    n = []

    def check(t, j):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(j, np.float32))
        n.append(1)

    tree_map(check, ttree, jnp_tree)
    assert len(n) == len(jax.tree.leaves(jtree))


@pytest.mark.parametrize("drop", [(), ("coarse_matching.src_proj.weight",
                                       "backbone.fine_out.bias")])
def test_port_matcher_equals_jax(drop):
    cfg = small_cfg()
    jparams = init_matcher(jax.random.key(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    sd = matcher_state_dict(jparams, cfg, np.random.default_rng(0), drop)
    jported, jrep = jport.port_matcher(sd, jparams,
                                       cfg.transformer.layer_types)
    tported, trep = tport.port_matcher(sd, tparams,
                                       cfg.transformer.layer_types)
    assert trep == jrep
    assert sorted(trep["missing"]) == sorted(drop)
    assert all("tgt_proj" in u for u in trep["unused"]) and trep["unused"]
    _assert_same(tported, jported)
    # a leaf with no name in the state dict keeps its value
    if drop:
        assert torch.equal(tported["matching"]["src_proj"],
                           params_from_numpy(jax.tree.map(
                               np.asarray, init_matcher(jax.random.key(0),
                                                        cfg)),
                               "cpu")["matching"]["src_proj"])


def test_port_neco_equals_jax():
    cfg = NeCoConfig(feature_dim=48, n_head=4, num_layers=2)
    jparams = init_neco(jax.random.key(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    sd = neco_state_dict(np.random.default_rng(1))
    jported, jrep = jport.port_neco(sd, jparams)
    tported, trep = tport.port_neco(sd, tparams)
    assert trep == jrep
    assert trep["missing"] == [] and trep["unused"] == ["extra.buffer"]
    _assert_same(tported, jported)
    assert torch.equal(tported["in_proj"]["w"],
                       torch.from_numpy(sd["in_proj.weight"].T.copy()))


def test_load_torch_state_dict(tmp_path):
    sd = {"a.weight": torch.randn(3, 4), "a.bias": torch.randn(3)}
    for wrap in (False, True):
        path = tmp_path / f"ckpt{wrap}.pth"
        torch.save({"state_dict": sd, "epoch": 3} if wrap else sd, path)
        got = tport.load_torch_state_dict(str(path))
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            assert isinstance(got[k], np.ndarray)
            assert np.array_equal(got[k], v.numpy())
    # through to a tree: the leaves land as float32 where the old ones were
    tree = {"in_proj": {"w": torch.zeros(6, 3), "b": torch.zeros(3)},
            "layers": [], "cls1": {"w": torch.zeros(3, 64),
                                   "b": torch.zeros(64)}}
    ported, rep = tport.port_neco(
        {"in_proj.weight": np.ones((3, 6), np.float64)}, tree)
    assert ported["in_proj"]["w"].dtype == torch.float32
    assert torch.equal(ported["in_proj"]["w"], torch.ones(6, 3))
    assert "classification.0.weight" in rep["missing"]
    assert all(t.device.type == "cpu" for t in tree_leaves(ported))
