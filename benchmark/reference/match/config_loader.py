# Frozen copy of deformationpyramid_tpu_torch/match/config_loader.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1 (without the yaml loading).
"""Build matcher/NeCo dataclass configs from the reference-format YAML tree.

Counterpart of ``deformationpyramid_tpu/match/config_loader.py``, reading
the same ``config/configs/*.yaml`` files. Mirrors the reference's config
composition (``landmark_estimator.py:18-29``,
``main.py:33-36``): the LNDP config points to a correspondence config which
points to the lepard + outlier_rejection configs.
"""
from __future__ import annotations

import os

from ..attrdict import AttrDict
from .kpconv import KPConvConfig
from .landmark import LandmarkConfig
from .matching import MatchingConfig
from .outlier_rejection import NeCoConfig
from .pipeline import MatcherConfig
from .position_encoding import VolPEConfig
from .procrustes import ProcrustesConfig
from .transformer import TransformerConfig


def matcher_config_from_yaml(cfg: AttrDict,
                             max_matches: int | None = None) -> MatcherConfig:
    k = cfg.kpfcn_config
    kpfcn = KPConvConfig(
        num_kernel_points=k.get("num_kernel_points", 15),
        in_points_dim=k.get("in_points_dim", 3),
        KP_extent=k.get("KP_extent", 2.0),
        conv_radius=k.get("conv_radius", 2.5),
        deform_radius=k.get("deform_radius", 5.0),
        modulated=k.get("modulated", False),
        KP_influence=k.get("KP_influence", "linear"),
        aggregation_mode=k.get("aggregation_mode", "sum"),
        fixed_kernel_points=k.get("fixed_kernel_points", "center"),
        use_batch_norm=k.get("use_batch_norm", True),
        batch_norm_momentum=k.get("batch_norm_momentum", 0.02),
        first_subsampling_dl=k.get("first_subsampling_dl", 0.01),
        first_feats_dim=k.get("first_feats_dim", 256),
        in_feats_dim=k.get("in_feats_dim", 1),
        coarse_feature_dim=k.get("coarse_feature_dim", 528),
        fine_feature_dim=k.get("fine_feature_dim", 264),
        coarse_level=k.get("coarse_level", -2),
    )
    inference_dtype = cfg.get("inference_dtype", "float32")
    m = cfg.coarse_matching
    matching = MatchingConfig(
        feature_dim=m.get("feature_dim", 528),
        confidence_threshold=m.get("confidence_threshold", 0.1),
        dsmax_temperature=m.get("dsmax_temperature", 0.1),
        match_type=m.get("match_type", "dual_softmax"),
        skh_init_bin_score=m.get("skh_init_bin_score", 1.0),
        skh_iters=m.get("skh_iters", 3),
        max_matches=max_matches,
        compute_dtype=inference_dtype,
    )
    t = cfg.coarse_transformer
    vol_bnds = t.get("vol_bnds", [[-3.6, -2.4, 1.14], [1.093, 0.78, 2.92]])
    vol = VolPEConfig(feature_dim=t.get("feature_dim", 528),
                      voxel_size=t.get("voxel_size", 0.04),
                      vol_origin=tuple(vol_bnds[0]),
                      pe_type=t.get("pe_type", "rotary"))
    proc = t.get("procrustes", AttrDict())
    procrustes = ProcrustesConfig(
        sample_rate=proc.get("sample_rate", 1.0),
        max_condition_num=proc.get("max_condition_num", 40.0),
        # read for the same files; the port's top-k is exact either way
        topk_method=cfg.get("topk_method", proc.get("topk_method", "approx")),
        approx_recall_target=cfg.get(
            "approx_recall_target",
            proc.get("approx_recall_target", 0.95)))
    transformer = TransformerConfig(
        feature_dim=t.get("feature_dim", 528),
        n_head=t.get("n_head", 4),
        layer_types=tuple(t.get("layer_types",
                                ["self", "cross", "positioning", "self", "cross"])),
        positioning_type=t.get("positioning_type", "procrustes"),
        pe_type=t.get("pe_type", "rotary"),
        vol=vol, matching=matching, procrustes=procrustes,
        compute_dtype=inference_dtype,
        attention_impl=cfg.get("attention_impl", "xla"))
    n_levels = 4  # kpfcn_backbone architecture
    coarse_level = kpfcn.coarse_level
    return MatcherConfig(kpfcn=kpfcn, transformer=transformer,
                         matching=matching, procrustes=procrustes,
                         coarse_level=coarse_level % n_levels,
                         max_matches=max_matches)


def neco_config_from_yaml(cfg: AttrDict) -> NeCoConfig:
    m = cfg.model
    return NeCoConfig(
        in_dim=m.get("in_dim", 6),
        feature_dim=m.get("feature_dim", 144),
        n_head=m.get("n_head", 8),
        num_layers=m.get("num_layers", 9),
        pe_type=m.get("pe_type", "rotary"),
        voxel_size=m.get("voxel_size", 0.08),
        sigma_spat=m.get("sigma_spat", 0.1),
        spatial_consistency_check=m.get("spatial_consistency_check", True))
