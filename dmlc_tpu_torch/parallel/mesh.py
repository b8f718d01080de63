"""Meshes over the ranks of a process group, and the batch placement.

The port's copy of the JAX package's ``parallel/mesh.py``. A JAX mesh lays
the pod's devices out on named axes and XLA inserts the collectives; here
each rank is one process with one device, the mesh names the ranks' axes,
and the learners issue their collectives themselves through
:meth:`Mesh.all_reduce_`: over every rank, or over one axis, the ranks
that differ only in their coordinate on it. Data parallelism splits
batches over the data axis and sums gradients over it; feature sharding
(``LinearLearner(model_axis=)``) splits the weight table over the model
axis and sums the partial margins over it. A learner without a model axis
on a mesh that has one keeps its parameters replicated over it.

The ranks are laid out row-major over the axes, as JAX's ``make_mesh``
reshapes its devices: on ``{"data": D, "model": M}`` rank ``r`` has data
coordinate ``r // M`` and model coordinate ``r % M``.

torch has no global tensor. A rank's batch is its slice of the global
batch, and the global batch is the concatenation of the data ranks'
batches in data order, as ``jax.make_array_from_process_local_data`` lays
it out; the ranks of one model group hold the same rows.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.parallel.distributed import group_ready, nccl_device
from dmlc_tpu_torch.utils.check import DMLCError, check


class Mesh:
    """Named axes over the ranks of the default process group.

    ``axis_names``, ``shape`` (axis -> size, as ``mesh.shape["data"]``
    reads in JAX), ``ranks`` (the rank ids laid out on the axes, row-major),
    this process's ``rank``, its ``coords`` on each axis and its
    ``device``. ``distributed`` is whether collectives go through the
    process group; a mesh made without one spans this process alone.
    ``groups`` maps each axis of more than one rank to this rank's process
    group along it (:func:`make_mesh` builds them).
    """

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], device: torch.device,
                 rank: int = 0, distributed: bool = False, groups: Optional[dict] = None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        self.ranks = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.rank = int(rank)
        self.coords = {name: int(c) for name, c in zip(
            self.axis_names, np.unravel_index(self.rank, self.ranks.shape))}
        self.device = device
        self.distributed = bool(distributed)
        self.groups = dict(groups or {})

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"distributed={self.distributed})")

    def _group(self, axis: str):
        """This rank's group along ``axis``; None where the axis holds this
        rank alone (or there is no process group): nothing to reduce."""
        if axis not in self.shape:
            raise DMLCError(f"axis {axis!r} is not an axis of {self.shape}")
        if not self.distributed or self.shape[axis] == 1:
            return None
        return self.groups[axis]

    def all_reduce_(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum ``t`` in place and return it: over every rank when ``axis``
        is None (issued in a group of one too), else over the ranks that
        differ only on ``axis`` (an axis of one rank issues nothing).
        Without a process group the mesh is this process alone and ``t`` is
        the result."""
        if axis is None:
            if self.distributed:
                dist.all_reduce(t)
            return t
        group = self._group(axis)
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` concatenated on dim 0 in their
        coordinate order (``t`` itself on an axis of one rank)."""
        group = self._group(axis)
        if group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)


class Sharding(NamedTuple):
    """Where an array lives on a mesh: ``spec`` names the mesh axis each
    array dimension is split over (None: not split); ``()`` is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def rank_device(mesh: Optional[Mesh], device=None, *, data_axis: str = "data",
                model_axis: Optional[str] = None, who: str = "mesh") -> torch.device:
    """The device of a learner or a DeviceIter: ``device`` (None: the card)
    without a mesh; on a mesh, the mesh's, which a ``device`` the caller
    names must be. Raises when ``data_axis`` or ``model_axis`` is not an
    axis of the mesh (JAX's ``mesh.shape[model_axis]`` raises there too),
    or when they name one axis."""
    if mesh is None:
        return resolve_device(device)
    for role, axis in (("data_axis", data_axis), ("model_axis", model_axis)):
        if axis is not None and axis not in mesh.shape:
            raise DMLCError(f"{who}: {role} {axis!r} is not an axis of {mesh.shape}")
    if model_axis == data_axis:
        raise DMLCError(f"{who}: model_axis and data_axis are both {data_axis!r}")
    if device is not None and resolve_device(device) != mesh.device:
        raise DMLCError(f"{who}: device {device} is not the mesh's {mesh.device}")
    return mesh.device


def shard_window(mesh: Optional[Mesh], axis: Optional[str], size: int) -> Tuple[int, int]:
    """``(lo, width)``: this rank's block of a dimension of ``size`` split
    evenly over ``axis``, the block at its coordinate there; the whole
    dimension, ``(0, size)``, without a mesh or an axis."""
    if mesh is None or axis is None:
        return 0, size
    parts = mesh.shape[axis]
    check(size % parts == 0, f"a dimension of {size} does not split evenly over "
                             f"{parts} ranks of {axis!r}")
    width = size // parts
    return mesh.coords[axis] * width, width


def _rank_device(devices, rank: int, world: int) -> torch.device:
    if devices is None:
        return nccl_device() or resolve_device(None)
    if isinstance(devices, (str, torch.device)):
        return resolve_device(devices)
    devices = list(devices)
    if len(devices) != world:
        raise ValueError(f"mesh over {len(devices)} devices but the group has {world} "
                         "ranks (one device a rank)")
    return resolve_device(devices[rank])


def make_mesh(axes: Optional[Dict[str, int]] = None, *, devices=None) -> Mesh:
    """A mesh over the default group's ranks from an axis -> size dict,
    e.g. ``{"data": 4}`` or ``{"data": 2, "model": 2}``; ``-1`` for one axis
    infers it. Without ``axes``, one ``data`` axis over every rank. The
    sizes must multiply to the world size (1 without a group). The ranks
    are laid out row-major, and each axis's groups are built here, once
    (:func:`_axis_groups`): every rank of the group must call this with
    the same axes.

    ``devices`` is this rank's device: None for the group's card (NCCL) or
    the card (raises without one), a device for every rank, or a sequence
    with one device a rank, in rank order.
    """
    ready = group_ready()
    world = dist.get_world_size() if ready else 1
    rank = dist.get_rank() if ready else 0
    device = _rank_device(devices, rank, world)
    if nccl_device() is not None and device.type != "cuda":
        raise DMLCError(f"make_mesh: an NCCL group's collectives need a CUDA device, not {device}")
    if not axes:
        axes = {"data": world}
    names, sizes = list(axes.keys()), list(axes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    if math.prod(sizes) != world:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} != {world} devices "
                         "(one a rank)")
    groups = _axis_groups(names, sizes, rank) if ready else {}
    return Mesh(names, sizes, device, rank=rank, distributed=ready, groups=groups)


def _axis_groups(names, sizes, rank: int) -> dict:
    """This rank's process group along each axis of more than one rank:
    the default group where the axis spans every rank, else one
    ``dist.new_group`` for each set of ranks that differ only on that axis.
    Every rank creates every group, in the same order (axes in order, the
    sets in row-major order), as ``new_group`` requires, or the ranks
    hang. A group that cannot be formed raises."""
    world = math.prod(sizes)
    layout = np.arange(world).reshape(sizes)
    groups = {}
    for i, (name, size) in enumerate(zip(names, sizes)):
        if size == 1:
            continue
        if size == world:
            groups[name] = dist.group.WORLD
            continue
        for members in np.moveaxis(layout, i, -1).reshape(-1, size).tolist():
            try:
                group = dist.new_group(members)
            except (RuntimeError, ValueError) as exc:
                raise DMLCError(f"make_mesh: the group of ranks {members} along "
                                f"{name!r} could not be formed: {exc}") from exc
            if rank in members:
                groups[name] = group
    return groups


def data_sharding(mesh: Mesh, *, axis: str = "data", ndim: int = 1) -> Sharding:
    """Batch dimension split over the data axis, the rest replicated."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def host_shard_info(num_parts_hint: Optional[int] = None) -> Tuple[int, int]:
    """``(part_index, num_parts)`` of this rank's InputSplit shard: the
    group's ``(rank, world)`` (``(0, 1)`` without a group), or ``(0,
    num_parts_hint)`` where the caller names the part count."""
    if num_parts_hint is not None:
        return 0, num_parts_hint
    if group_ready():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_to_global(mesh: Mesh, local_arrays, *,
                          axis: str = "data") -> Tuple[torch.Tensor, ...]:
    """This rank's slice of a global batch, on the mesh's device.

    Each rank contributes its InputSplit shard's rows; the global batch
    is the concatenation of the ranks' slices in rank order (the layout of
    ``jax.make_array_from_process_local_data``), and no rank ever holds
    it whole. The arrays of one batch must agree on their row count."""
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh.shape}")
    out = tuple(torch.as_tensor(a).to(mesh.device) for a in local_arrays)
    rows = {t.shape[0] if t.dim() else None for t in out}
    if len(rows) > 1 or None in rows:
        raise ValueError(f"local batch arrays disagree on their rows: {sorted(map(str, rows))}")
    return out
