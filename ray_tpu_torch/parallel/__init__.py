from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh, mesh_shape_for
from ray_tpu_torch.parallel.pipeline import (
    bubble_fraction,
    pipeline_apply,
    pipeline_train_step,
    schedule_ticks,
    stash_depth,
)
from ray_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_sharded
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    logical_sharding,
    shard_constraint,
    shard_pytree,
)
from ray_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = [
    "MeshConfig",
    "ShardingRules",
    "bubble_fraction",
    "logical_sharding",
    "make_mesh",
    "mesh_shape_for",
    "pipeline_apply",
    "pipeline_train_step",
    "ring_attention",
    "ring_attention_sharded",
    "schedule_ticks",
    "shard_constraint",
    "shard_pytree",
    "stash_depth",
    "ulysses_attention",
    "ulysses_attention_sharded",
]
