"""Multi-process runtime setup.

Port of ``gnn_tpu/parallel/multihost.py`` onto ``torch.distributed``:
:func:`initialize` makes the process group (NCCL for a CUDA device, gloo for
the CPU), after which :func:`~gnn_tpu_torch.parallel.make_mesh` spans every
process and the halo exchange of :mod:`gnn_tpu_torch.parallel.halo` rides the
group's collectives (``all_to_all_single``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``)::

    from gnn_tpu_torch.parallel import multihost, make_mesh, partition_graph
    multihost.initialize()                   # the torchrun environment
    mesh = make_mesh(axes=("data",))         # one part on each process's card
    dist = partition_graph(ei, w, num_nodes=N, mesh=mesh, halo="alltoall")

Nothing on the machine tells a process of its peers: without arguments,
:func:`initialize` reads the ``torchrun`` environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); otherwise pass the address
(``host:port`` for TCP, or a ``file://`` store), the process count and this
process's index. On the cards each process holds exactly one: the index of
``device`` where the launcher names it (``torch.multiprocessing.spawn``
passes each process its own), else ``LOCAL_RANK`` (``torchrun``), else the
process index modulo the card count. ``timeout`` (seconds) bounds how long
a collective waits for the other processes, so that a process whose peer
has died fails instead of waiting for good.

:func:`all_reduce_gradients` sums the gradients of replicated parameters
over a group in one coalesced all-reduce (a dtype), the step that keeps
every process's parameters equal bit for bit after the optimizer: ``fit``
calls it after ``backward`` over the mesh's ``data_group``.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as tdist

__all__ = ["initialize", "is_multihost", "process_count", "local_devices", "all_reduce_gradients", "barrier"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    timeout: Optional[float] = None,
) -> None:
    """Make the process group (a no-op when one exists): NCCL where
    ``device`` is a CUDA device (made this process's current device: its
    index, or ``LOCAL_RANK``, or the process index modulo the card count),
    gloo for ``device="cpu"``. ``timeout``: seconds a collective may wait
    (torch's default where None)."""
    if tdist.is_initialized():
        return
    device = torch.device(device)
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"multihost.initialize() without an address reads the torchrun environment, "
                f"which lacks {missing}: pass coordinator_address, num_processes and process_id"
            )
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError("pass num_processes and process_id with coordinator_address")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", int(process_id) % max(torch.cuda.device_count(), 1)))
        if not 0 <= index < torch.cuda.device_count():
            raise RuntimeError(f"process {process_id} asks for card {index}; this host has {torch.cuda.device_count()}")
        torch.cuda.set_device(index)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"multihost.initialize runs on CUDA or CPU devices, got {device}")
    tdist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes), rank=int(process_id),
        timeout=None if timeout is None else datetime.timedelta(seconds=timeout),
    )


def is_multihost() -> bool:
    return process_count() > 1


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def local_devices() -> List[torch.device]:
    """This process's cards, or the CPU where it has none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def barrier(device) -> None:
    """``torch.distributed.barrier`` over the default group that names this
    process's card on NCCL, which would otherwise guess it."""
    device = torch.device(device)
    if device.type != "cuda":
        tdist.barrier()
        return
    tdist.barrier(device_ids=[torch.cuda.current_device() if device.index is None else device.index])


def all_reduce_gradients(parameters: Iterable[torch.Tensor], group) -> None:
    """Sum every parameter's ``.grad`` over ``group`` in place (those whose
    grad is None are left so on every process): one all-reduce over the
    gradients laid end to end, one a dtype."""
    by_dtype = {}
    for p in parameters:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        tdist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()
