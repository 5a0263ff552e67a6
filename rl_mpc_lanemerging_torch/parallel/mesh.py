"""Device mesh and scenario sharding.

Port of ``rl_mpc_lanemerging_tpu/parallel/mesh.py``.  The framework's
primary parallel axis is the scenario batch (SURVEY §2.3): every data
structure carries a leading batch dimension, and data parallelism splits
that axis over the ranks.  JAX places one global array with a
``NamedSharding``; here each rank is a process (``torch.distributed``) that
holds only its own contiguous slice of the batch, so that rank r of n holds
global scenarios ``[r * b, (r + 1) * b)`` with ``b = B / n``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils._pytree import tree_map_only

__all__ = ["SCENARIO_AXIS", "make_mesh", "scenario_sharding", "shard_batch",
           "padded_batch"]

SCENARIO_AXIS = "scenario"


def make_mesh(device_type: str = "cuda", shape: Sequence[int] = None,
              axes: Sequence[str] = (SCENARIO_AXIS,)) -> DeviceMesh:
    """A mesh over every rank of the initialised process group: 1-D over
    the scenario axis by default; ``shape=(s, m)`` with ``axes=("scenario",
    "model")`` gives the 2-D mesh the tensor-parallel rules use."""
    shape = tuple(shape) if shape is not None else (dist.get_world_size(),)
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def scenario_sharding(mesh: DeviceMesh, axis: str = SCENARIO_AXIS):
    """The DTensor placements of a batch split on its leading axis over
    ``axis`` and replicated over any other axis (JAX: ``NamedSharding(mesh,
    P(axis))``)."""
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def padded_batch(batch: int, mesh: DeviceMesh,
                 axis: str = SCENARIO_AXIS) -> int:
    """``batch`` rounded up to a multiple of the ranks on ``axis`` (the JAX
    package pads the same way, tasks.py:74)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return -(-batch // n) * n


def _rank_slice(x: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    if x.ndim == 0:
        return x
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split over "
                         f"{n} ranks; pad the batch (padded_batch)")
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def shard_batch(tree, mesh: DeviceMesh, axis: str = SCENARIO_AXIS):
    """This rank's contiguous slice of the leading axis of every tensor of a
    batched tree (such as ``WorldState``, ``HighwayState`` or a controller
    carry), in rank order.  0-dim tensors are kept whole."""
    dim = mesh.mesh_dim_names.index(axis)
    rank, n = mesh.get_local_rank(dim), mesh.size(dim)
    return tree_map_only(torch.Tensor, lambda x: _rank_slice(x, rank, n),
                         tree)
