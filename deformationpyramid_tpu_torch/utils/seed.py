"""Deterministic seeding (reference ``utils/benchmark_utils.py:9-18``).

Counterpart of ``deformationpyramid_tpu/utils/seed.py``. The reference
seeds torch, CUDA, numpy and ``random`` globally; the JAX package seeds
numpy and ``random`` and returns its root PRNG key. Here the global
generators are seeded as in the reference, and a seeded
``torch.Generator`` is returned for code that takes its draws explicitly
(the port's initialisers do).
"""
from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int) -> torch.Generator:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)     # every CUDA device's generator too
    return torch.Generator().manual_seed(seed)
