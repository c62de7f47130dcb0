"""Worker of tests/test_torch_four_process.py: one of four processes of a
gloo group on the CPU, each holding one mesh position, the layout of one
process a card on four cards. It runs ``fit`` on 4 parts (one part a
process), the tensor-parallel GCN on a (2, 2) (data, model) mesh (model
groups {0, 1} and {2, 3}, data groups {0, 2} and {1, 3}) and
``dryrun_multichip(4)``, and writes what each check found into
``{directory}/rank{rank}.json``: "ok" or the failure. Imports no JAX
(checked at the end). :func:`cards_spmm` and :func:`cards_fit` run the
same group over NCCL on four cards, one a process, for
``tests/test_torch_cuda.py``."""

import json
import sys
import traceback

import numpy as np
import torch
import torch.distributed as tdist

from torch_group_fit_worker import check_curves, data_of, model_of, same_on_every_process, tensors_of
from torch_tensor_parallel_worker import check, loss_and_grads

from gnn_tpu_torch.entry import dryrun_multichip
from gnn_tpu_torch.parallel import make_mesh, multihost
from gnn_tpu_torch.train import Config, fit
from gnn_tpu_torch.train import loop

WORLD = 4
CPU = torch.device("cpu")


def fit_one_part_a_process(case: dict, name: str) -> None:
    """``fit`` on 4 parts, each process holding one (checked on the step
    ``fit`` builds), against the one-process curve; the final parameters and
    buffers equal on the four processes."""
    steps, build_step = [], loop.build_step

    def captured(*args):
        steps.append(build_step(*args))
        return steps[-1]

    data = data_of(case)
    cfg = Config.from_dict(case["cfg"])
    loop.build_step = captured
    try:
        model, state, history = fit(cfg, data, model=model_of(cfg, data, case["params"]), device="cpu",
                                    verbose=False)
    finally:
        loop.build_step = build_step
    mesh = steps[0].mesh
    if mesh.num_local_parts != 1 or mesh.first_part != tdist.get_rank() or mesh.data_count != WORLD:
        raise AssertionError(f"{name}: {mesh.num_local_parts} parts from part {mesh.first_part} on this process")
    check_curves(case, history, name)
    same_on_every_process(tensors_of(model, state), name)


def tensor_parallel(tp: dict) -> None:
    """The (2, 2) mesh of one position a process against the JAX values."""
    rank = tdist.get_rank()
    mesh = make_mesh((2, 2), ("data", "model"), devices=[CPU])
    if (mesh.model_group is None or mesh.data_count != 2 or mesh.data_index != rank // 2
            or list(mesh.local_shards) != [rank % 2] or mesh.first_part != rank // 2):
        raise AssertionError(f"(2, 2) over four processes: rank {rank} got data index {mesh.data_index} of "
                             f"{mesh.data_count}, shards {list(mesh.local_shards)}, part {mesh.first_part}")
    model_ranks = tdist.get_process_group_ranks(mesh.model_group)
    data_ranks = tdist.get_process_group_ranks(mesh.data_group)
    if model_ranks != [rank - rank % 2, rank - rank % 2 + 1] or data_ranks != [rank % 2, rank % 2 + 2]:
        raise AssertionError(f"rank {rank}: model group {model_ranks}, data group {data_ranks}")
    check(*loss_and_grads(tp["graph"], tp["weights"], mesh), tp["loss"], tp["grads"], "(2, 2) mesh")


def run(rank: int, store: str, cases: dict, tp: dict, directory: str) -> None:
    torch.set_num_threads(1)  # graphs of a few hundred nodes: threads would only contend for the cores
    multihost.initialize(store, WORLD, rank, device="cpu", timeout=60)
    found = {}

    def section(name, fn, *args):
        try:
            fn(*args)
            found[name] = "ok"
        except Exception:  # recorded for the test of this check; the others go on
            found[name] = traceback.format_exc()

    for name, case in cases.items():
        section(f"fit {name}", fit_one_part_a_process, case, name)
    section("tensor parallel", tensor_parallel, tp)
    section("dryrun_multichip", dryrun_multichip, WORLD, "cpu")
    found["jax imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    with open(f"{directory}/rank{rank}.json", "w") as f:
        json.dump(found, f)
    tdist.destroy_process_group()


# -- on four cards (tests/test_torch_cuda.py, marked gpu): one process a card, NCCL


def card_graph():
    """A power-law graph with GCN weights, as in the card tests."""
    from gnn_tpu_torch import graphs as tg

    n = 3000
    ei, _ = tg.to_undirected(tg.power_law(n, 40000, seed=0), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    return ei, w, n


def cards_spmm(rank: int, store: str) -> None:
    """``spmm_dist`` forward and dx in each halo mode and the
    ``gather_src_dist`` VJP with one part a card, against this card's rows
    of single-device K1 (rtol 1e-4, atol 1e-4), bitwise on a repeat, one K1
    launch a direction (two in 'overlap')."""
    from gnn_tpu_torch import graphs as tg
    from gnn_tpu_torch.ops.cuda.spmm import csr_spmm
    from gnn_tpu_torch.parallel import gather_src_dist, partition_graph, spmm_dist

    dev = torch.device("cuda", rank)
    multihost.initialize(store, WORLD, rank, device=dev, timeout=60)
    ei, w, n = card_graph()
    adj = tg.build_adjacency(ei, w, num_nodes=n).to(dev)
    gen = torch.Generator().manual_seed(3)
    x, g = torch.randn(n, 40, generator=gen).to(dev), torch.randn(n, 40, generator=gen).to(dev)
    mesh = make_mesh(axes=("data",))
    if mesh.num_local_parts != 1 or mesh.device != dev:
        raise AssertionError(f"rank {rank}: {mesh.num_local_parts} parts on {mesh.device}")
    for halo in ("allgather", "alltoall", "overlap"):
        dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo=halo)
        xr = dist.shard_nodes(x).requires_grad_()
        before = csr_spmm.launches
        out = spmm_dist(dist, xr)
        out.backward(dist.shard_nodes(g))
        torch.cuda.synchronize()
        launches = csr_spmm.launches - before
        torch.testing.assert_close(out, dist.shard_nodes(csr_spmm(adj.row_ptr, adj.src, adj.weight, x)),
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(xr.grad, dist.shard_nodes(csr_spmm(adj.t_row_ptr, adj.t_col, adj.t_weight, g)),
                                   rtol=1e-4, atol=1e-4)
        if not torch.equal(out, spmm_dist(dist, xr.detach())):
            raise AssertionError(f"{halo}: a second call gave other bits")
        if launches != (4 if halo == "overlap" else 2):
            raise AssertionError(f"{halo}: K1 launched {launches} times for the forward and dx")
        if halo == "alltoall":
            xe = dist.shard_nodes(x).requires_grad_()
            gather_src_dist(dist, xe).sum().backward()
            torch.testing.assert_close(xe.grad, dist.shard_nodes(csr_spmm(
                adj.t_row_ptr, adj.t_col, None, torch.ones(n, 40, device=dev))), rtol=1e-4, atol=1e-4)
    tdist.destroy_process_group()


def cards_fit(rank: int, store: str, cases: dict) -> None:
    """``fit`` on 4 parts, one a card, against the 4-part ``fit`` in one
    process on one card (rtol 1e-5) with the same launches of K1 and K2;
    the final parameters and buffers equal on the four cards."""
    from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr
    from gnn_tpu_torch.ops.cuda.spmm import csr_spmm

    dev = torch.device("cuda", rank)
    multihost.initialize(store, WORLD, rank, device=dev, timeout=60)
    for name, case in cases.items():
        data = data_of(case)
        cfg = Config.from_dict(case["cfg"])
        before = (csr_spmm.launches, segment_sum_csr.launches)
        model, state, history = fit(cfg, data, model=model_of(cfg, data, None), device=dev, verbose=False)
        torch.cuda.synchronize()
        launches = [csr_spmm.launches - before[0], segment_sum_csr.launches - before[1]]
        np.testing.assert_allclose([h["loss"] for h in history], case["losses"], rtol=1e-5, err_msg=name)
        if launches != case["launches"]:
            raise AssertionError(f"{name}: K1, K2 launched {launches} times, {case['launches']} in one process")
        same_on_every_process([t.to(dev) for t in tensors_of(model, state)], name)
    tdist.destroy_process_group()
