"""Two processes of a gloo group on the CPU, each holding 2 of 4 parts:
``spmm_dist`` (alltoall, allgather and overlap) and ``gather_src_dist``,
forward and gradient, against the dense oracle on every local shard, through
the group's collectives (``all_to_all_single``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``). The store is a file in ``tmp_path`` (no port to
collide with under xdist); the workers import no JAX; 120 s at most."""

import time

import torch.multiprocessing as mp

import torch_multihost_worker


def test_two_process_gloo_partition_matches_dense(tmp_path):
    ctx = mp.spawn(torch_multihost_worker.run, args=(f"file://{tmp_path / 'store'}",), nprocs=2, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two-process run took more than 120 s")
