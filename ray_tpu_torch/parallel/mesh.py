"""Device mesh construction (port of ray_tpu/parallel/mesh.py).

One ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, whose dims carry the JAX package's axis names:

    dp    data parallel (pure replica)
    fsdp  data parallel with parameter sharding (ZeRO-3 style)
    tp    tensor (megatron) parallel
    sp    Ulysses sequence parallel (all-to-all head scattering; ulysses.py)
    cp    context parallel (ring attention over sequence; ring_attention.py)
    ep    expert parallel (MoE; expert.py)
    pp    pipeline parallel (stages; pipeline.py)

``MeshConfig`` keeps all seven axes, as the JAX package does, and the
sharding rules (``sharding.py``) speak of all seven. The ``DeviceMesh``
itself is built over the axes of size > 1 only: a size-1 axis replicates by
construction, so the placements are the same either way, while DTensor's
sharding propagation enumerates placements over every mesh dim, so one
elementwise op on a seven-dim mesh of five size-1 dims takes tens of
seconds of host time the first time it meets a shape (``python -m
ray_tpu_torch.mesh_times`` measures it). A config with no axis above 1 (one
rank) gets a one-dim mesh ``("dp",)`` of size 1. ``axis_size`` reads any of
the seven names, 1 for those the mesh leaves out.

The process group is the caller's: ``torch.distributed.init_process_group``
comes first, with an address, world size and rank of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch._device import resolve_device

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "cp", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    cp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    # multi-slice factors: N identical groups of ranks (slices) joined by a
    # slower network; they multiply INTO the logical dp/pp axes, so the
    # placements are unchanged and a slice's ranks stay contiguous
    dcn_dp: int = 1
    dcn_pp: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        """LOGICAL axis sizes (dcn factors folded into pp/dp)."""
        return {"pp": self.pp * self.dcn_pp, "dp": self.dp * self.dcn_dp,
                "fsdp": self.fsdp, "ep": self.ep, "cp": self.cp,
                "sp": self.sp, "tp": self.tp}

    def slice_axis_sizes(self) -> Dict[str, int]:
        """Per-slice axis sizes."""
        return {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                "ep": self.ep, "cp": self.cp, "sp": self.sp, "tp": self.tp}

    @property
    def num_slices(self) -> int:
        return self.dcn_dp * self.dcn_pp

    @property
    def devices_per_slice(self) -> int:
        return self.pp * self.dp * self.fsdp * self.ep * self.cp * self.sp * self.tp

    @property
    def num_devices(self) -> int:
        return self.devices_per_slice * self.num_slices

    def validate(self, available: int) -> None:
        if self.num_devices != available:
            raise ValueError(
                f"MeshConfig uses {self.num_devices} devices "
                f"({self.axis_sizes()}, {self.num_slices} slice(s)), "
                f"but {available} are available"
            )

    @classmethod
    def auto(cls, n_devices: int, tp: int = 1, cp: int = 1, sp: int = 1,
             ep: int = 1, pp: int = 1) -> "MeshConfig":
        """Fill the leftover factor into fsdp (FSDP over everything not used
        by tp/cp/sp/ep/pp)."""
        used = tp * cp * sp * ep * pp
        if n_devices % used:
            raise ValueError(f"{n_devices} devices not divisible by tp*cp*sp*ep*pp={used}")
        return cls(dp=1, fsdp=n_devices // used, tp=tp, cp=cp, sp=sp, ep=ep, pp=pp)


def mesh_shape_for(config: MeshConfig) -> Tuple[Tuple[str, int], ...]:
    """(axis_name, size) pairs in AXIS_ORDER, all seven of them."""
    sizes = config.axis_sizes()
    return tuple((name, sizes[name]) for name in AXIS_ORDER)


def mesh_ranks(config: MeshConfig, ranks: Sequence[int]) -> np.ndarray:
    """The ranks laid out over the seven logical axes, in AXIS_ORDER.

    One slice: the ranks in order, reshaped (the JAX package's layout of
    host devices). Several slices: the ranks form contiguous virtual slices,
    and each dcn factor takes the OUTER position of its logical axis, so
    index = slice_part * ici_size + ici_part (the JAX package's
    ``_hybrid_mesh_array`` for devices without slice metadata)."""
    config.validate(len(ranks))
    logical = config.axis_sizes()
    arr = np.asarray(list(ranks), dtype=np.int64)
    if config.num_slices == 1:
        return arr.reshape(tuple(logical[n] for n in AXIS_ORDER))
    per = config.slice_axis_sizes()
    arr = arr.reshape((config.dcn_pp, config.dcn_dp) + tuple(per[n] for n in AXIS_ORDER))
    # (dcn_pp, dcn_dp, *slice axes) -> (dcn_pp, pp, dcn_dp, dp, *rest): each
    # dcn factor moves adjacent-outer to its logical axis, then the pairs merge
    pp_pos = 2 + AXIS_ORDER.index("pp")
    dp_pos = 2 + AXIS_ORDER.index("dp")
    rest = [i for i in range(2, arr.ndim) if i not in (pp_pos, dp_pos)]
    arr = arr.transpose([0, pp_pos, 1, dp_pos] + rest)
    return arr.reshape(tuple(logical[n] for n in AXIS_ORDER))


def make_mesh(config: Optional[MeshConfig] = None, *, device_type: Optional[str] = None,
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """Build the ``DeviceMesh`` of ``config`` (default: ``MeshConfig.auto``
    over every rank) over ``ranks`` (default: every rank of the default
    process group), on ``device_type``: "cuda" unless "cpu" is asked."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    device_type = resolve_device(device_type).type
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if config is None:
        config = MeshConfig.auto(len(ranks))
    arr = mesh_ranks(config, ranks)
    keep = [i for i, size in enumerate(arr.shape) if size > 1] or [AXIS_ORDER.index("dp")]
    names = tuple(AXIS_ORDER[i] for i in keep)
    return DeviceMesh(device_type, arr.reshape(tuple(arr.shape[i] for i in keep)).tolist(),
                      mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """Size of mesh axis ``name``; 1 for an axis the mesh leaves out."""
    if name not in AXIS_ORDER:
        raise ValueError(f"unknown mesh axis {name!r}; axes: {AXIS_ORDER}")
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def group_position(mesh: DeviceMesh, axis_name: str):
    """(process group, this rank's index in it, its size) of mesh axis
    ``axis_name``; (None, 0, 1) for an axis the mesh leaves out."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return None, 0, 1
    group = mesh.get_group(axis_name)
    return group, dist.get_group_rank(group, dist.get_rank()), n


def data_axes() -> Tuple[str, ...]:
    """Mesh axes that shard the batch dimension."""
    return ("dp", "fsdp")


def batch_sharding_spec() -> Tuple:
    """Mesh axes of a [batch, seq, ...] input batch: batch over dp+fsdp,
    sequence over cp (context parallel). ``sharding.spec_placements`` turns
    it into placements."""
    return (("dp", "fsdp"), "cp")
