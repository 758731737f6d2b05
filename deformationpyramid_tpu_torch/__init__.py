"""deformationpyramid_tpu_torch — the Neural Deformation Pyramid in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``deformationpyramid_tpu`` (JAX, TPU), which stays beside it as
the reference. Module names mirror the JAX package's:

  data/      synthetic deformed pairs, PLY I/O, the KPConv collate (numpy,
             copied)
  geometry/  rotation parameterizations
  models/    the NDP pyramid (stacked level params, flat level layout)
  ops/       1-NN (kernel C1), truncated chamfer, the fused iteration
             (kernels C2-C4) and the landmark iteration (kernel C5), the
             kernels' build and binding (cuda_lib)
  csrc/      the CUDA C++ sources of the kernels
  solve/     Adam with the device-side early stop, the registration engine
  match/     the learned landmark model of LNDP: KPFCN backbone,
             repositioning transformer (attention on kernel C7), dual-softmax
             matching, soft Procrustes, NeCo outlier rejection
  metrics/   scene-flow metrics, inlier ratio and NRFMR
  utils/     the yaml config loader
  cli/       the Sim(3) shape-transfer demo

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
