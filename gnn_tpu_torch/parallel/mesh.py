"""The device mesh of a node-partitioned graph.

Port of ``gnn_tpu/parallel/mesh.py``. A :class:`Mesh` names its axes and
sizes and holds, for each ``data`` part of this process, its device. The
parts of one process share that process's device: one process can hold all
P parts of a partition on one card (``devices=[torch.device("cuda:0")] *
4``) or on the CPU (``[torch.device("cpu")] * P``, the counterpart of the JAX
tests' virtual devices), and their halo exchange is then index work on that
device. Where a ``torch.distributed`` group is initialized
(:func:`gnn_tpu_torch.parallel.multihost.initialize`), the mesh spans every
process of it: process r holds the parts ``[r L, (r + 1) L)`` and the
exchange rides the group's collectives.

Only the partition axis runs: an axis after the first (the JAX package's
``model`` axis, tensor parallelism) larger than 1 raises
``NotImplementedError`` (ROADMAP Queue 1 item 15). The GSPMD annotations of
the JAX module (``replicated``, ``shard``, ``P``, ``NamedSharding``) have no
counterpart: the port places tensors itself.
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
    devices: Tuple[torch.device, ...]  # this process's parts, one device for all
    process_index: int = 0
    process_count: int = 1
    grouped: bool = False  # exchanges ride the torch.distributed group

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
    def num_local_parts(self) -> int:
        return len(self.devices)


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Sequence[str] = ("data", "model"),
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over every process of the ``torch.distributed`` group (one
    process when none is initialized), each contributing ``devices``: its
    parts' devices, one device repeated. ``devices=None`` gives each process
    one part on its card. Defaults: every part on the first axis (``data``),
    the others of size 1; ``shape`` overrides the sizes."""
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
    if any(s > 1 for s in shape[1:]):
        raise NotImplementedError(
            f"mesh axes {dict(zip(axes, shape))}: only the partition axis runs; tensor parallelism "
            "over a second axis (the 'model' axis) is not ported yet (ROADMAP Queue 1 item 15)"
        )
    return Mesh(axes, shape, devices, process_index=rank, process_count=world, grouped=grouped)
