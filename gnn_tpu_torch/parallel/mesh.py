"""The device mesh: a ``data`` axis of graph parts and a ``model`` axis of
tensor-parallel shards.

Port of ``gnn_tpu/parallel/mesh.py``. A :class:`Mesh` names its axes and
sizes, row-major as a JAX mesh over its devices: position ``i`` is part ``i
// M`` of the first (partition, ``data``) axis and shard ``i % M`` of the
second (``model``) axis, of size ``M`` (1 when there is none). Each process
holds a contiguous run of positions, all on its one device: one process can
hold every position (``devices=[torch.device("cuda:0")] * 4``, or ``[cpu] *
P``, the counterpart of the JAX tests' virtual devices), and then a halo
exchange is index work on that device and the model shards of a part are
column blocks side by side there, with no collective.

Where a ``torch.distributed`` group is initialized
(:func:`gnn_tpu_torch.parallel.multihost.initialize`), the mesh spans every
process of it, each contributing ``devices``. A process holds either whole
rows of the mesh (``len(devices)`` a multiple of ``M``: several parts, every
shard of each) or a run of shards of one part (``M`` a multiple of
``len(devices)``). The collectives then ride subgroups: ``data_group`` (the
processes that hold the same shards, one per run of parts) carries the halo
exchange and every sum over the graph (the loss's and the accuracies'
counts, BatchNorm's statistics, the gradients), ``model_group`` (the
processes that hold the shards of the same part) carries the gather of the
column blocks and the sum of ``dx`` in :mod:`~gnn_tpu_torch.parallel.
tensor_parallel`; it is None where one process holds every shard. The GSPMD
annotations of the JAX module (``replicated``, ``shard``, ``P``,
``NamedSharding``) have no counterpart: the port places tensors itself, and
:func:`~gnn_tpu_torch.parallel.tensor_parallel.shard_model` is the placement
``NamedSharding(mesh, P("model", None))`` of every Linear's weight.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

__all__ = ["Mesh", "make_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]  # this process's positions, one device for all
    process_index: int = 0
    process_count: int = 1
    grouped: bool = False  # collectives ride the torch.distributed group
    data_group: object = None  # ProcessGroup of the data axis (grouped only)
    model_group: object = None  # ProcessGroup of the model axis, where it spans processes
    data_index: int = 0  # this process's index among the data group's processes
    data_count: int = 1  # the processes along the data axis

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def model_size(self) -> int:
        """M: the size of the model axis (the second), 1 without one."""
        return self.axis_sizes[1] if len(self.axis_sizes) > 1 else 1

    @property
    def first_position(self) -> int:
        return self.process_index * len(self.devices)

    @property
    def num_local_parts(self) -> int:
        """The ``data`` parts this process holds (its positions count the
        model shards too)."""
        return max(len(self.devices) // self.model_size, 1)

    @property
    def first_part(self) -> int:
        return self.first_position // self.model_size

    @property
    def local_shards(self) -> range:
        """The model shards this process holds of each of its parts."""
        m0 = self.first_position % self.model_size
        return range(m0, m0 + min(len(self.devices), self.model_size))


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _subgroups(world: int, rank: int, M: int, n_local: int):
    """(data group, model group, data index, data count) of a grouped mesh
    of ``world`` processes with ``n_local`` positions each and a model axis
    of ``M``. Every process makes every subgroup, in the same order
    (``new_group`` is collective over the world).

    Where a process holds whole rows of the mesh (``n_local`` a multiple of
    ``M``), the data group is the world and there is no model group. Where
    ``span = M / n_local`` processes share one part, the processes ``[d
    span, (d + 1) span)`` hold part ``d``'s shards and form its model group,
    and the processes ``{m, m + span, m + 2 span, ...}`` hold the same
    shards of every part and form a data group. Four processes of one
    position on a (2, 2) mesh: model groups {0, 1} and {2, 3}, data groups
    {0, 2} and {1, 3}; on a (1, 2) mesh of two processes: the model group
    {0, 1} and the data groups {0} and {1}."""
    if n_local % M == 0:  # whole rows of the mesh: data across every process
        return tdist.group.WORLD, None, rank, world
    span = M // n_local  # the processes that share one part
    model_groups = [tdist.new_group(list(range(d * span, (d + 1) * span))) for d in range(world // span)]
    data_groups = [tdist.new_group(list(range(m, world, span))) for m in range(span)]
    return data_groups[rank % span], model_groups[rank // span], rank // span, world // span


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Sequence[str] = ("data", "model"),
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over every process of the ``torch.distributed`` group (one
    process when none is initialized), each contributing ``devices``: its
    positions' devices, one device repeated. ``devices=None`` gives each
    process one position on its card. Defaults: every position on the first
    axis (``data``), the others of size 1; ``shape`` overrides the sizes.
    The first axis partitions the graph, the second (``model``) shards the
    Linear layers; a third axis must have size 1."""
    grouped = tdist.is_available() and tdist.is_initialized()
    world = tdist.get_world_size() if grouped else 1
    rank = tdist.get_rank() if grouped else 0
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() puts a part on this process's card, and none is available; "
                "pass devices=[torch.device('cpu')] * num_parts for the CPU"
            )
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = tuple(_normalize(d) for d in devices)
    if not devices or any(d != devices[0] for d in devices):
        raise ValueError(f"the parts of one process share one device, got {list(devices)}")
    n = world * len(devices)
    axes = tuple(axes)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name one size per axis of {axes}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    if any(s > 1 for s in shape[2:]):
        raise ValueError(
            f"mesh axes {dict(zip(axes, shape))}: the port's meshes have a partition (data) axis and a "
            "model axis; every further axis must have size 1"
        )
    M, n_local = (shape[1] if len(shape) > 1 else 1), len(devices)
    if n_local % M and M % n_local:
        raise ValueError(
            f"{n_local} positions a process and a model axis of {M}: a process holds whole rows of the "
            "mesh (a multiple of the model axis) or a run of one part's shards (a divisor of it)"
        )
    groups = _subgroups(world, rank, M, n_local) if grouped else (None, None, 0, 1)
    return Mesh(axes, shape, devices, process_index=rank, process_count=world, grouped=grouped,
                data_group=groups[0], model_group=groups[1], data_index=groups[2], data_count=groups[3])
