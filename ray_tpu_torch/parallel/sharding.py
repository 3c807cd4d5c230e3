"""Logical-axis sharding rules (port of ray_tpu/parallel/sharding.py).

Parameters and activations are annotated with *logical* axis names
("embed", "mlp", "heads", "vocab", "batch", "seq", ...); a ``ShardingRules``
table maps each logical name to mesh axes, and the mesh axes of a tensor's
dims (its *spec*, the counterpart of a JAX ``PartitionSpec``) become DTensor
placements: a tensor dim mapped to mesh axis ``a`` is ``Shard(dim)`` on
``a``'s mesh dim, every other mesh dim is ``Replicate()``.

A tuple of axes on one tensor dim, such as ``("dp", "fsdp")`` for the batch,
shards that dim over both, major to minor in the tuple's order. DTensor
shards one tensor dim over several mesh dims in the mesh's dim order, so the
tuple must follow ``AXIS_ORDER`` (it does in every rule here). Where such a
dim does not divide by the product of the axes, DTensor's nested chunks
(6 over 2 x 2: 2, 1, 2, 1) differ from JAX's (2, 2, 2, 0): ``shard_tensor``
refuses it. A mesh axis may appear at most once in a spec, as in JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ray_tpu_torch.parallel.mesh import AXIS_ORDER

MeshAxes = Union[None, str, Tuple[str, ...]]


def _axes_tuple(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_placements(mesh, spec: Sequence[MeshAxes]) -> Tuple:
    """Placements on ``mesh`` of a tensor whose dim i is sharded over the
    mesh axes ``spec[i]`` (None, a name, or a tuple of names). Axes the mesh
    leaves out (size 1) replicate."""
    placements = [Replicate()] * mesh.ndim
    seen = set()
    for dim, axes in enumerate(spec):
        axes = _axes_tuple(axes)
        for a in axes:
            if a not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {a!r} in spec {tuple(spec)}")
            if a in seen:
                raise ValueError(f"mesh axis {a!r} appears more than once in spec {tuple(spec)}")
            seen.add(a)
        if list(axes) != sorted(axes, key=AXIS_ORDER.index):
            raise ValueError(f"spec {tuple(spec)}: the axes {axes} of dim {dim} must follow "
                             f"the mesh order {AXIS_ORDER}")
        for a in axes:
            if a in mesh.mesh_dim_names:
                placements[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return tuple(placements)


@dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, MeshAxes], ...]

    def lookup(self, logical_name: str) -> MeshAxes:
        for name, axes in self.rules:
            if name == logical_name:
                return axes
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Tuple[MeshAxes, ...]:
        """The mesh axes of each tensor dim (a JAX PartitionSpec's entries)."""
        return tuple(self.lookup(a) if a is not None else None for a in logical_axes)

    def placements(self, mesh, logical_axes: Sequence[Optional[str]]) -> Tuple:
        """DTensor placements on ``mesh`` of a tensor with these logical axes."""
        return spec_placements(mesh, self.spec(logical_axes))

    def with_overrides(self, **overrides: MeshAxes) -> "ShardingRules":
        new = [(n, overrides.get(n, a)) for n, a in self.rules]
        for n, a in overrides.items():
            if not any(r[0] == n for r in self.rules):
                new.append((n, a))
        return ShardingRules(tuple(new))


# Default LLM rules: FSDP shards the embed dim of every WEIGHT, TP shards
# heads/mlp/vocab, CP shards sequence, batch over (dp, fsdp). Activations use
# distinct logical names ("act_*"): their batch dim already consumes the fsdp
# axis, so the activation embed dim must NOT also map to fsdp (a mesh axis may
# appear at most once per spec).
DEFAULT_LLM_RULES = ShardingRules(
    rules=(
        ("batch", ("dp", "fsdp")),
        ("seq", "cp"),
        ("embed", "fsdp"),
        ("heads", "tp"),
        ("kv_heads", "tp"),
        ("head_dim", None),
        ("mlp", "tp"),
        ("vocab", "tp"),
        ("layers", None),
        ("expert", "ep"),
        ("stage", "pp"),
        # activation dims
        ("act_embed", None),
        ("act_heads", "tp"),
        ("act_kv_heads", "tp"),
        ("act_vocab", "tp"),
    )
)


def logical_sharding(mesh, rules: ShardingRules, logical_axes: Sequence[Optional[str]]) -> Tuple:
    """Placements on ``mesh`` for a tensor whose dims carry the given logical
    names (the counterpart of a ``NamedSharding``)."""
    return rules.placements(mesh, logical_axes)


def shard_tensor(x, mesh, placements) -> DTensor:
    """``x`` as a DTensor with ``placements``: a DTensor is redistributed (a
    differentiable collective, whose backward lays the cotangent out the same
    way, as a JAX sharding constraint does); a plain tensor, the same global
    values on every rank, is cut into this rank's shard without
    communication."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    for dim in range(x.dim()):
        sizes = [mesh.shape[i] for i, p in enumerate(placements) if p == Shard(dim)]
        if len(sizes) > 1 and x.shape[dim] % int(torch.tensor(sizes).prod()):
            raise ValueError(f"dim {dim} of size {x.shape[dim]} is sharded over mesh dims of "
                             f"sizes {sizes} and does not divide by their product")
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def shard_constraint(x, mesh, rules: ShardingRules, logical_axes: Sequence[Optional[str]]):
    """``x`` laid out by logical names (with_sharding_constraint's
    counterpart): a redistribute for a DTensor."""
    return shard_tensor(x, mesh, rules.placements(mesh, logical_axes))


def axes_is_leaf(v: Any) -> bool:
    """True for logical-axes leaves: None, or a plain tuple of axis names."""
    return v is None or (
        type(v) is tuple and all(a is None or isinstance(a, str) for a in v)
    )


def _map_axes(axes_tree: Any, fn):
    """``fn`` over the logical-axes leaves of a tree of dicts and dataclasses
    (TrainState, AdamWState); other dataclass fields (counts) stay as they are."""
    if axes_is_leaf(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(v, fn) for k, v in axes_tree.items()}
    if dataclasses.is_dataclass(axes_tree):
        return dataclasses.replace(axes_tree, **{
            f.name: _map_axes(getattr(axes_tree, f.name), fn)
            for f in dataclasses.fields(axes_tree)})
    raise TypeError(f"not a tree of logical axes: {type(axes_tree).__name__}")


def _map2(tree: Any, axes_tree: Any, fn):
    """``fn(leaf, axes)`` over a tree and its parallel tree of logical axes."""
    if axes_is_leaf(axes_tree):
        return fn(tree, axes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map2(tree[k], v, fn) for k, v in axes_tree.items()}
    if dataclasses.is_dataclass(axes_tree):
        return dataclasses.replace(tree, **{
            f.name: _map2(getattr(tree, f.name), getattr(axes_tree, f.name), fn)
            for f in dataclasses.fields(axes_tree)})
    raise TypeError(f"not a tree of logical axes: {type(axes_tree).__name__}")


def sharding_pytree(axes_tree: Any, mesh, rules: ShardingRules):
    """Tree of placements from a tree of logical-axis tuples (None: every
    mesh dim replicates)."""
    return _map_axes(axes_tree, lambda axes: rules.placements(mesh, axes or ()))


def shard_pytree(tree: Any, axes_tree: Any, mesh, rules: ShardingRules):
    """Place a tree of tensors by a parallel tree of logical-axis tuples.
    Leaves that are not tensors (a step count) stay as they are."""
    def place(x, axes):
        if not torch.is_tensor(x):
            return x
        return shard_tensor(x, mesh, rules.placements(mesh, axes or ()))

    return _map2(tree, axes_tree, place)
