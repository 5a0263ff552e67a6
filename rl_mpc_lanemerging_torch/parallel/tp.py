"""Tensor-parallel sharding rules for the port's networks.

Port of ``rl_mpc_lanemerging_tpu/parallel/tp.py``.  The networks are small
256-wide MLPs (reference dqn.py:568-579), so tensor parallelism is not
load-bearing (SURVEY §2.3); the rules let a network's layers be split over
a ``model`` mesh axis when it is scaled up.  Default: everything
replicated.

Rules are (regex, ``ParallelStyle`` or None) pairs matched against the
dotted module path (``layers.Dense_0``); the first match wins, and a path
that no rule matches, or whose first match is None, stays replicated.
:func:`shard_params` applies them with ``parallelize_module``;
:func:`mlp_tp_rules` is the canonical recipe for the fully connected stacks
(Megatron): the first layer column-parallel, the second row-parallel, so
that the activation between them stays sharded and one ``all_reduce``
joins the second layer's partial sums; later layers replicated.

A Flax kernel is (in, out) and a torch weight (out, in): JAX's
``P(None, axis)`` on ``Dense_0/kernel`` is ``Shard(0)`` of the weight, and
``P(axis, None)`` on ``Dense_1/kernel`` is ``Shard(1)``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               ParallelStyle,
                                               RowwiseParallel,
                                               parallelize_module)

__all__ = ["MODEL_AXIS", "param_path_specs", "shard_params", "mlp_tp_rules"]

MODEL_AXIS = "model"

Rules = Sequence[Tuple[str, Optional[ParallelStyle]]]

# where each style puts an nn.Linear's parameters on the model axis
_LINEAR_PLACEMENTS = {
    ColwiseParallel: {"weight": Shard(0), "bias": Shard(0)},
    RowwiseParallel: {"weight": Shard(1), "bias": Replicate()},
}


def _plan(module: torch.nn.Module, rules: Rules
          ) -> Dict[str, ParallelStyle]:
    """The first matching rule's style for each module path that has one."""
    plan = {}
    for path, _ in module.named_modules():
        for pattern, style in rules:
            if re.search(pattern, path):
                if style is not None:
                    plan[path] = style
                break
    return plan


def param_path_specs(module: torch.nn.Module, rules: Rules = ()
                     ) -> Dict[str, object]:
    """Each parameter's placement on the model axis, by its dotted name:
    its layer's first matching rule's, else ``Replicate()``."""
    plan = _plan(module, rules)
    specs = {}
    for name, _ in module.named_parameters():
        path, _, leaf = name.rpartition(".")
        style = plan.get(path)
        specs[name] = Replicate() if style is None \
            else _LINEAR_PLACEMENTS[type(style)][leaf]
    return specs


def shard_params(module: torch.nn.Module, mesh: DeviceMesh,
                 rules: Rules = (), axis: str = MODEL_AXIS
                 ) -> torch.nn.Module:
    """Split ``module``'s layers over the ``axis`` of ``mesh`` by ``rules``,
    in place (unmatched layers stay plain, replicated tensors).  Every rank
    must hold the same full module (from one checkpoint, or broadcast from
    rank 0): each keeps its own slice with no communication, which also
    keeps ``gloo`` usable on the card (it has no scatter of CUDA
    tensors)."""
    tp_mesh = mesh[axis] if mesh.ndim > 1 else mesh
    return parallelize_module(module, tp_mesh, _plan(module, rules),
                              src_data_rank=None)


def mlp_tp_rules() -> Rules:
    """Megatron-style rules for ``Dense_i`` stacks: ``Dense_0``
    column-parallel (its outputs and bias split), ``Dense_1`` row-parallel
    (its inputs split, bias replicated), later layers replicated (JAX
    tp.py:69-77)."""
    return (
        (r"Dense_0$", ColwiseParallel()),
        (r"Dense_1$", RowwiseParallel()),
        (r"Dense_\d+$", None),
    )
