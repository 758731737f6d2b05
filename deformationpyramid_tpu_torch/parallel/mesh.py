"""Process-group and device-mesh runtime layer.

Counterpart of ``deformationpyramid_tpu/parallel/mesh.py``. The reference
is single-process, single-GPU (SURVEY.md §2.4); the JAX package lays a
(data, model) ``jax.sharding.Mesh`` over its devices. Here a rank is one
process driving one card, ``torchrun`` starts the ranks, and the same
(data, model) mesh is a ``DeviceMesh`` over the ranks: the data axis
shards the pairs of a sweep or a batch, the model axis the target points
of one large nearest-neighbour sweep. Collectives ride NCCL between cards,
gloo between CPU processes.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(device: torch.device | str = "cuda") -> bool:
    """Join the process group that ``torchrun`` describes.

    Reads ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``. Returns False for a world of one process (nothing is
    initialised, as the JAX package's single-process fallback), True once
    the group is up: ``nccl`` with the current card set to
    ``cuda:LOCAL_RANK`` when ``device`` is CUDA, ``gloo`` on the CPU. A
    group that is already up is kept.
    """
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ["MASTER_PORT"]
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)
    return True


def local_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for CUDA (the current card
    where no launcher set ``LOCAL_RANK``), else ``device`` as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_data: int | None = None, n_model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the process group.

    Defaults to every rank on the data axis: registration is embarrassingly
    parallel over pairs, so data parallelism is the primary axis. Rank r
    sits at (r // n_model, r % n_model)."""
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"{n_data}x{n_model} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
