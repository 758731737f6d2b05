"""Port reference PyTorch checkpoints into the port's parameter trees.

Counterpart of ``deformationpyramid_tpu/match/port_torch.py``: the same
name map, transposes, skipped weights and report, onto the port's trees of
tensors (each ported leaf lands on the device of the leaf it replaces, as
float32). The reference ships pretrained Lepard matcher + NeCo weights
(``correspondence/configs/correspondence.yaml:1-5``, loaded at
``landmark_estimator.py:33-39``). This module maps those ``state_dict``
names onto our functional param trees so users can migrate without
retraining. torch ``nn.Linear`` weights are [out, in] and transpose to our
[in, out]; ``Conv1d`` 1x1 weights [out, in, 1] squeeze+transpose; KPConv
weights are [K, in, out] in both. InstanceNorm blocks carry no parameters
(affine=False in the reference, ``blocks.py:445``).

Known-dead reference weights are skipped by design and reported:
``tgt_proj`` in Matching (never used — ``matching.py:126-127`` applies
src_proj twice) and decoder blocks beyond the coarse exit.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a torch checkpoint (CPU) into numpy arrays."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in state:
        state = state["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if hasattr(v, "detach")}


class _Porter:
    def __init__(self, sd: dict[str, np.ndarray]):
        self.sd = sd
        self.used: set[str] = set()
        self.missing: list[str] = []

    def take(self, name: str, transform: Callable[[np.ndarray], np.ndarray] = None):
        if name not in self.sd:
            self.missing.append(name)
            return None
        self.used.add(name)
        arr = self.sd[name]
        return transform(arr) if transform else arr

    def linear_w(self, name):   # [out, in] -> [in, out]
        return self.take(name, lambda a: a.T)

    def conv1d_w(self, name):   # [out, in, 1] -> [in, out]
        return self.take(name, lambda a: a[..., 0].T)


def _set(tree: dict, path: list, value):
    """Replace the leaf at ``path`` by ``value`` (a numpy array) as a
    float32 tensor on the old leaf's device; None leaves it as it was."""
    if value is None:
        return
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = torch.from_numpy(
        np.array(value, dtype=np.float32)).to(node[path[-1]].device)


def _port_attention_layer(pt: _Porter, prefix: str, layer: dict):
    _set(layer, ["q"], pt.linear_w(f"{prefix}.q_proj.weight"))
    _set(layer, ["k"], pt.linear_w(f"{prefix}.k_proj.weight"))
    _set(layer, ["v"], pt.linear_w(f"{prefix}.v_proj.weight"))
    _set(layer, ["merge"], pt.linear_w(f"{prefix}.merge.weight"))
    _set(layer, ["mlp1"], pt.linear_w(f"{prefix}.mlp.0.weight"))
    _set(layer, ["mlp2"], pt.linear_w(f"{prefix}.mlp.2.weight"))
    _set(layer, ["ln1", "g"], pt.take(f"{prefix}.norm1.weight"))
    _set(layer, ["ln1", "b"], pt.take(f"{prefix}.norm1.bias"))
    _set(layer, ["ln2", "g"], pt.take(f"{prefix}.norm2.weight"))
    _set(layer, ["ln2", "b"], pt.take(f"{prefix}.norm2.bias"))


def port_matcher(sd: dict[str, np.ndarray], params: dict,
                 layer_types=("self", "cross", "positioning", "self", "cross"),
                 ) -> tuple[dict, dict]:
    """Map a reference ``Pipeline`` state_dict onto ``init_matcher`` params.

    Returns (params, report) where report lists used/missing/unused names.
    """
    pt = _Porter(sd)

    # ---- KPFCN backbone ----
    enc = params["backbone"]["encoder"]
    for i, blk in enumerate(enc):
        pfx = f"backbone.encoder_blocks.{i}"
        _set(blk, ["kpconv", "weights"], pt.take(f"{pfx}.KPConv.weights"))
        _set(blk, ["kpconv", "kernel_points"],
             pt.take(f"{pfx}.KPConv.kernel_points"))
        if "offset_conv" in blk["kpconv"]:  # deformable KPConv
            _set(blk, ["kpconv", "offset_conv", "weights"],
                 pt.take(f"{pfx}.KPConv.offset_conv.weights"))
            _set(blk, ["kpconv", "offset_conv", "kernel_points"],
                 pt.take(f"{pfx}.KPConv.offset_conv.kernel_points"))
            _set(blk, ["kpconv", "offset_bias"],
                 pt.take(f"{pfx}.KPConv.offset_bias"))
        for ours, theirs in (("unary1", "unary1"), ("unary2", "unary2"),
                             ("shortcut", "unary_shortcut")):
            if ours in blk:
                _set(blk, [ours, "w"], pt.linear_w(f"{pfx}.{theirs}.mlp.weight"))
    dec = params["backbone"]["decoder"]
    for i, blk in enumerate(dec):
        if blk:  # unary
            _set(blk, ["w"], pt.linear_w(f"backbone.decoder_blocks.{i}.mlp.weight"))
    _set(params["backbone"], ["coarse_out", "w"],
         pt.conv1d_w("backbone.coarse_out.weight"))
    _set(params["backbone"], ["coarse_out", "b"],
         pt.take("backbone.coarse_out.bias"))
    _set(params["backbone"], ["fine_out", "w"],
         pt.conv1d_w("backbone.fine_out.weight"))
    _set(params["backbone"], ["fine_out", "b"],
         pt.take("backbone.fine_out.bias"))

    # ---- repositioning transformer ----
    for i, l_type in enumerate(layer_types):
        layer = params["transformer"]["layers"][i]
        pfx = f"coarse_transformer.layers.{i}"
        if l_type in ("self", "cross"):
            _port_attention_layer(pt, pfx, layer)
        elif l_type == "positioning":
            _set(layer, ["src_proj"], pt.linear_w(f"{pfx}.0.src_proj.weight"))
            if "bin_score" in layer:
                _set(layer, ["bin_score"], pt.take(f"{pfx}.0.bin_score"))

    # ---- coarse matching head ----
    _set(params["matching"], ["src_proj"],
         pt.linear_w("coarse_matching.src_proj.weight"))
    if "bin_score" in params["matching"]:
        _set(params["matching"], ["bin_score"],
             pt.take("coarse_matching.bin_score"))

    unused = sorted(set(sd) - pt.used)
    return params, {"missing": pt.missing, "unused": unused,
                    "used": sorted(pt.used)}


def port_neco(sd: dict[str, np.ndarray], params: dict) -> tuple[dict, dict]:
    """Map a reference ``Outlier_Rejection`` state_dict onto NeCo params."""
    pt = _Porter(sd)
    _set(params, ["in_proj", "w"], pt.linear_w("in_proj.weight"))
    _set(params, ["in_proj", "b"], pt.take("in_proj.bias"))
    for i, layer in enumerate(params["layers"]):
        _port_attention_layer(pt, f"_6D_geometry_layers.{i}", layer)
    for ours, theirs in (("cls1", "classification.0"),
                         ("cls2", "classification.2"),
                         ("cls3", "classification.4")):
        _set(params, [ours, "w"], pt.linear_w(f"{theirs}.weight"))
        _set(params, [ours, "b"], pt.take(f"{theirs}.bias"))
    unused = sorted(set(sd) - pt.used)
    return params, {"missing": pt.missing, "unused": unused,
                    "used": sorted(pt.used)}
