"""deformationpyramid_tpu_torch — the Neural Deformation Pyramid in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``deformationpyramid_tpu`` (JAX, TPU), which stays beside it as
the reference. Module names mirror the JAX package's:

  data/      synthetic deformed pairs, PLY I/O, the KPConv collate, the
             4DMatch reader, the deformation graph from a depth map
             (graph: mesh, nodes, geodesic edges, anchors; numpy / scipy,
             copied)
  geometry/  rotation parameterizations, camera (depth <-> points, pixel
             maps), kabsch (rigid_fit, the ED warp ed_warp)
  models/    the NDP pyramid (stacked level params, flat level layout), the
             NSFP and Nerfies baselines
  ops/       1-NN (kernel C1 both ways, kernel C14 one way), truncated
             chamfer, the fused iteration (kernels C2-C4, C6, C10, C11),
             the landmark iteration (kernel C5), the fused chamfer (C12),
             the standalone level warp (C2, C3, C13), render (the depth /
             silhouette renderer, silhouette_cost, point_2_plane_distance
             on C14), sinkhorn, the kernels' build and binding (cuda_lib)
  csrc/      the CUDA C++ sources of the kernels
  losses/    landmark, ARAP (arap_cost), Nerfies' elastic term, BCE
  solve/     Adam with the device-side early stop (lr_decay, a random
             stream for resampling losses), the registration engine, the
             baselines (NSFP, Nerfies, Sinkhorn, ED / N-ICP register_ed),
             the continuous-batching stream (streaming: every slot's 1-NN
             one launch of C1)
  native/    the C++ collate (voxel barycentres, radius neighbours), built
             with the host compiler at first use
  match/     the learned landmark model of LNDP: KPFCN backbone,
             repositioning transformer (attention on kernel C7, its
             backward on C8 / C9), dual-softmax matching, soft Procrustes,
             NeCo outlier rejection, their losses
  train/     the matcher's and NeCo's trainers
  metrics/   scene-flow metrics, inlier ratio and NRFMR
  utils/     the yaml config loader, npz checkpoints, meters and timers
  cli/       the Sim(3) shape-transfer demo, the trainers, the no-learned
             evaluation (eval_nolearned) and the ED / N-ICP evaluation from
             depth maps (eval_ed)

Tensors on the CPU take each kernel's plain PyTorch version; tensors on a
CUDA device launch the kernels, which are compiled by nvcc at first use.
This package never imports JAX.
"""

from .models.pyramid import (NDPConfig, init_pyramid_params, warp, level_warp,
                             params_from_numpy, params_to_numpy)
from .solve.registration import (SolverConfig, register_pair, register_batch,
                                 make_register_fn)
from .ops.chamfer import truncated_chamfer, batched_truncated_chamfer
from .ops.knn import nn_argmin
from .metrics.flow import scene_flow_metrics, compute_flow_metrics

__version__ = "0.1.0"

__all__ = [
    "NDPConfig", "SolverConfig", "init_pyramid_params", "warp", "level_warp",
    "params_from_numpy", "params_to_numpy",
    "register_pair", "register_batch", "make_register_fn",
    "truncated_chamfer", "batched_truncated_chamfer", "nn_argmin",
    "scene_flow_metrics", "compute_flow_metrics",
]
