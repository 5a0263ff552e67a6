"""The scenario mesh over ``torch.distributed`` ranks: sharded evaluation,
data-parallel training and tensor-parallel rules."""

from .mesh import SCENARIO_AXIS, make_mesh, scenario_sharding, shard_batch

__all__ = ["SCENARIO_AXIS", "make_mesh", "scenario_sharding", "shard_batch"]
