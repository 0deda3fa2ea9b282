"""The rank mesh: data x model x ensemble process groups.

Port of ``anemoi_tpu.parallel.mesh``.  The JAX package lays its devices out
as one ``jax.sharding.Mesh`` with the axes

    data     -- data parallelism (batch rows; anemoi-core's DDP groups)
    model    -- model parallelism (grid and hidden node rows; the model group)
    ensemble -- ensemble parallelism (the members of an ensemble split
                over the group, :func:`member_block`)

in ``reshape(data, model, ensemble)`` order.  Here the world of ranks is
laid out the same way by rank arithmetic (:func:`mesh_coords`), and
:func:`create_mesh` builds one ``torch.distributed`` process group per line
of each axis, so that every rank knows its data group, its model group and
its index in each.

:func:`zero_sharding` keeps the JAX rule for the optimizer state (an array
is sharded over the data group only when its first axis divides by the
group's size) and :func:`batch_sharding` its batch layout (batch rows over
the data group; grid rows over the model group with
``dataloader.shard_grid``), with the model group's grid blocks those of
``parallel/partition.py``.  Along the ``ensemble`` axis every rank reads
the same batch rows and grid block and runs its block of the members
(:func:`member_block`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from anemoi_tpu_torch.parallel.partition import _round_up

AXES = ("data", "model", "ensemble")


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    model: int = 1
    ensemble: int = 1

    @property
    def world(self) -> int:
        return self.data * self.model * self.ensemble

    @classmethod
    def from_config(cls, config: dict, num_devices: Optional[int] = None) -> "MeshSpec":
        """The mesh of ``hardware`` (``num_devices_per_model``,
        ``num_devices_per_ensemble``) over ``num_devices`` ranks (default:
        the world's size)."""
        if num_devices is None:
            num_devices = dist.get_world_size() if dist.is_initialized() else 1
        n = int(num_devices)
        model = int(config.get("num_devices_per_model", 1))
        ensemble = int(config.get("num_devices_per_ensemble", 1))
        if n % (model * ensemble):
            raise AssertionError(
                f"{n} devices not divisible by model({model}) x ensemble({ensemble})")
        return cls(data=n // (model * ensemble), model=model, ensemble=ensemble)


def mesh_coords(rank: int, spec: MeshSpec) -> Tuple[int, int, int]:
    """``(data, model, ensemble)`` index of ``rank`` in the C-order
    ``reshape(data, model, ensemble)`` of the ranks."""
    return (rank // (spec.model * spec.ensemble), (rank // spec.ensemble) % spec.model,
            rank % spec.ensemble)


def axis_lines(spec: MeshSpec, axis: str) -> List[List[int]]:
    """Every group of ranks along ``axis`` (the others fixed), in order."""
    k = AXES.index(axis)
    lines: Dict[tuple, List[int]] = {}
    for rank in range(spec.world):
        coords = mesh_coords(rank, spec)
        lines.setdefault(coords[:k] + coords[k + 1:], []).append(rank)
    return list(lines.values())


@dataclass
class Mesh:
    """This rank's view of the mesh: its coordinates, and for each axis its
    group of ranks (None for an axis of size 1)."""

    spec: MeshSpec
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def coords(self) -> Tuple[int, int, int]:
        return mesh_coords(self.rank, self.spec)

    def size(self, axis: str) -> int:
        return getattr(self.spec, axis)

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_root(self) -> bool:
        """Rank 0 of the world: the one that logs and writes."""
        return self.rank == 0


def create_mesh(spec: MeshSpec, device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the running world (``torch.distributed`` initialised,
    world size ``spec.world``), or the one-rank mesh.  Every rank creates
    every group, in the same order, as ``torch.distributed.new_group``
    requires."""
    device = torch.device("cpu") if device is None else torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < spec.world:
        raise ValueError(
            f"mesh spec needs {spec.world} devices (data={spec.data} x model={spec.model} x "
            f"ensemble={spec.ensemble}) but only {world} are visible; set "
            "hardware.num_devices to the available count or start that many ranks")
    if spec.world == 1:
        return Mesh(spec, 0, device)
    if world != spec.world:
        raise ValueError(f"mesh spec of {spec.world} ranks in a world of {world}")
    rank = dist.get_rank()
    mesh = Mesh(spec, rank, device)
    for axis in AXES:
        for line in axis_lines(spec, axis):
            group = dist.new_group(line) if len(line) > 1 else None
            if rank in line:
                mesh.groups[axis] = group
    return mesh


def zero_sharding(shape: Sequence[int], data_size: int) -> bool:
    """ZeRO's rule (JAX ``zero_sharding``): the optimizer state of an array
    is split over the data group only when its first axis divides by the
    group's size; everything else stays replicated."""
    return data_size > 1 and len(shape) >= 1 and shape[0] > 0 and shape[0] % data_size == 0


def block_rows(num_points: int, num_shards: int, bucket_multiple: int = 8) -> int:
    """The rows of one rank's block of a node set split over ``num_shards``
    (pad included): ``round_up(ceil(N / S), 8)``, as ``partition_graph``
    pads them."""
    if num_shards <= 1:
        return num_points
    return _round_up(-(-num_points // num_shards), bucket_multiple)


def grid_block(num_points: int, num_shards: int, index: int,
               bucket_multiple: int = 8) -> slice:
    """Rank ``index``'s rows of a node set split over ``num_shards``: the
    contiguous block of ``round_up(ceil(N / S), 8)`` rows that
    ``partition_graph`` gives it, clipped to the real rows (the last blocks
    may be short, or empty)."""
    if num_shards <= 1:
        return slice(0, num_points)
    n_local = block_rows(num_points, num_shards, bucket_multiple)
    lo = min(index * n_local, num_points)
    return slice(lo, min(lo + n_local, num_points))


@dataclass(frozen=True)
class BatchSharding:
    """The layout of a ``[B, T, E, G, V]`` batch over the mesh: batch rows
    over the data group, grid rows over the model group when
    ``shard_grid``."""

    data_size: int
    data_index: int
    model_size: int
    model_index: int
    shard_grid: bool

    def slices(self, global_shape: Sequence[int]) -> Tuple[slice, ...]:
        b = int(global_shape[0])
        if b % self.data_size:
            raise ValueError(f"batch of {b} rows does not split over {self.data_size} data ranks")
        rows = b // self.data_size
        batch = slice(self.data_index * rows, (self.data_index + 1) * rows)
        grid = (grid_block(int(global_shape[3]), self.model_size, self.model_index)
                if self.shard_grid else slice(0, int(global_shape[3])))
        return (batch, slice(None), slice(None), grid, slice(None))


def batch_sharding(mesh: Mesh, shard_grid: bool = True) -> BatchSharding:
    return BatchSharding(mesh.size("data"), mesh.index("data"), mesh.size("model"),
                         mesh.index("model"), bool(shard_grid) and mesh.size("model") > 1)


def member_block(ensemble_size: int, num_ranks: int, index: int) -> slice:
    """Rank ``index``'s members of an ensemble of ``ensemble_size`` split over
    an ensemble group of ``num_ranks``: a contiguous block of ``ensemble_size
    / num_ranks``, which must divide (JAX ``step.py:235-252`` shards the member
    axis evenly)."""
    if ensemble_size % num_ranks:
        raise ValueError(f"ensemble_size {ensemble_size} does not split over the ensemble "
                         f"group of {num_ranks} ranks (hardware.num_devices_per_ensemble)")
    m = ensemble_size // num_ranks
    return slice(index * m, (index + 1) * m)
