"""The port's distributed ops (``gnn_tpu_torch.parallel.halo``) against the
dense oracle and the JAX package's single-device ops, parts on the CPU.

These are the equalities the JAX package's own ``tests/test_parallel.py``
establishes for its ``shard_map`` ops (marked slow there): ``spmm_dist`` in
the three halo modes (with ``local_blocked``), ``gather_src_dist``,
``gather_dst_dist``, ``edge_reduce_by_dst``, ``spmm_dist_dynw`` /
``spmm_edge_weighted`` and ``with_weight(None)``, forward and gradient, at
rtol=1e-4, atol=1e-5. On the CPU every per-part product runs the kernels'
plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jgraphs
from gnn_tpu import ops as jops
from gnn_tpu_torch.ops import spmm, spmm_edge_weighted
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm
from gnn_tpu_torch.parallel import (
    edge_reduce_by_dst,
    edge_valid_mask,
    gather_dst_dist,
    gather_src_dist,
    make_mesh,
    partition_graph,
    shard_node_array,
    spmm_dist,
    spmm_dist_dynw,
)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
HALOS = ["allgather", "alltoall", "overlap"]


def _graph(rng, n=100, e=600, F=16):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ei, _ = jgraphs.coalesce(np.stack([src, dst]), num_nodes=n)
    ei, w = jgraphs.gcn_norm(np.asarray(ei), num_nodes=n)
    return np.asarray(ei), np.asarray(w), rng.normal(size=(n, F)).astype(np.float32), n


def _dense(ei, w, n):
    return np.asarray(jgraphs.to_dense_adj(ei, w, num_nodes=n))


def _setup(rng, P, halo, weighted=True, blocked=0, **graph):
    ei, w, x, n = _graph(rng, **graph)
    mesh = make_mesh(axes=("data",), devices=[CPU] * P)
    dist = partition_graph(ei, w if weighted else None, num_nodes=n, mesh=mesh, halo=halo, local_blocked=blocked)
    x_sh = shard_node_array(dist, x, mesh).requires_grad_()
    return ei, w, x, n, mesh, dist, x_sh


SPMM = [(h, P, 0) for h in HALOS for P in (2, 4, 8)] + [("overlap", 4, 8), ("overlap", 8, 8)]


@pytest.mark.parametrize("halo,P,blocked", SPMM, ids=[f"{h}-P{p}-R{b}" for h, p, b in SPMM])
def test_spmm_dist_and_its_gradient_match_dense(rng, halo, P, blocked):
    ei, w, x, n, mesh, dist, x_sh = _setup(rng, P, halo, blocked=blocked, n=197)
    A = _dense(ei, w, n)
    out = spmm_dist(dist, x_sh, mesh)
    np.testing.assert_allclose(dist.unshard_nodes(out).detach().numpy(), A @ x, **TOL)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(dist.unshard_nodes(x_sh.grad).numpy(), A.T @ np.cos(A @ x), **TOL)
    # padding rows neither receive nor send anything
    assert not out[dist.num_nodes :].any() and not x_sh.grad[dist.num_nodes :].any()


@pytest.mark.parametrize("halo", HALOS)
def test_spmm_dispatch_equals_jax_single_device_spmm(rng, halo):
    ei, w, x, n, mesh, dist, x_sh = _setup(rng, 4, halo)
    jadj = jgraphs.build_adjacency(ei, jnp.asarray(w), num_nodes=n, layout="csr")
    np.testing.assert_allclose(
        dist.unshard_nodes(spmm(dist, x_sh)).detach().numpy(), np.asarray(jops.spmm(jadj, x)), **TOL
    )


def test_local_blocked_bf16_blocks(rng):
    ei, w, x, n = _graph(rng, n=197)
    mesh = make_mesh(axes=("data",), devices=[CPU] * 4)
    dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="overlap", local_blocked=8, block_dtype=torch.bfloat16)
    out = spmm_dist(dist, shard_node_array(dist, x, mesh), mesh)
    np.testing.assert_allclose(dist.unshard_nodes(out).numpy(), _dense(ei, w, n) @ x, rtol=2e-2, atol=2e-2)


def test_overlap_local_product_reads_no_recv_slot(rng):
    """The overlap mode's local product reads the owned rows only: its CSR's
    columns stop at L n_max, and it equals the dense product over the edges
    whose source the destination's part owns, without any exchange."""
    ei, w, x, n, mesh, dist, x_sh = _setup(rng, 4, "overlap")
    L, n_max = 4, dist.n_max
    assert dist.adj.num_src_nodes == L * n_max and int(dist.adj.src.max()) < L * n_max
    same = (ei[0] // n_max) == (ei[1] // n_max)
    local = csr_spmm(dist.adj.row_ptr, dist.adj.src, dist.adj.weight, x_sh.detach())
    np.testing.assert_allclose(dist.unshard_nodes(local).numpy(), _dense(ei[:, same], w[same], n) @ x, **TOL)
    remote = csr_spmm(dist.adj_rem.row_ptr, dist.adj_rem.src, dist.adj_rem.weight, torch.zeros(L * L * dist.h_max, 16))
    assert not remote.any()  # with zero recv slots, the remote half adds nothing


def test_spmm_dist_checks_its_arguments(rng):
    ei, w, x, n, mesh, dist, x_sh = _setup(rng, 4, "alltoall")
    with pytest.raises(ValueError, match=r"\[P\*n_max, F\]"):
        spmm_dist(dist, x_sh[:, 0], mesh)
    with pytest.raises(ValueError, match="rows"):
        spmm_dist(dist, x_sh[:-1], mesh)
    with pytest.raises(ValueError, match="axis has 2 parts"):
        spmm_dist(dist, x_sh, make_mesh(axes=("data",), devices=[CPU] * 2))
    assert torch.equal(spmm_dist(dist, x_sh.detach()), spmm_dist(dist, x_sh.detach(), mesh))  # repeat: same bits
    bare = partition_graph(ei, w, num_nodes=n, num_parts=4)  # no mesh: no edge-parallel ops
    with pytest.raises(ValueError, match="no mesh"):
        gather_src_dist(bare, x_sh)
    with pytest.raises(ValueError, match="no mesh"):
        spmm(bare, x_sh)
    flat = partition_graph(ei, w, num_nodes=n, mesh=mesh, edge_parallel=False)
    with pytest.raises(ValueError, match="edge_parallel=True"):
        gather_src_dist(flat, x_sh)
    with pytest.raises(ValueError, match="unknown edge reduction"):
        edge_reduce_by_dst(dist, torch.zeros(4 * dist.e_max, 2), op="mean")


@pytest.mark.parametrize("halo", HALOS)
def test_gather_src_dist_and_its_gradient(rng, halo):
    ei, w, x, n, mesh, dist, x_sh = _setup(rng, 4, halo, weighted=False, n=80, e=400)
    got = gather_src_dist(dist, x_sh)
    valid = edge_valid_mask(dist).numpy()
    eid = dist.edge_id.reshape(-1).numpy()
    np.testing.assert_array_equal(got.detach().numpy()[valid], x[ei[0][eid[valid]]])
    assert not got[~torch.from_numpy(valid)].any()
    torch.sin(got).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.sin(jnp.take(v, jnp.asarray(ei[0]), axis=0))))(jnp.asarray(x))
    np.testing.assert_allclose(dist.unshard_nodes(x_sh.grad).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("halo", ["alltoall", "overlap"])
def test_gather_dst_dist_and_edge_reduce_by_dst(rng, halo):
    """Each the other's VJP; 'max' leaves -inf on rows without in-edges."""
    ei, w, x, n, mesh, dist, x_sh = _setup(rng, 4, halo, weighted=False, n=80, e=150)
    valid = edge_valid_mask(dist)
    eid = dist.edge_id.reshape(-1).numpy()[valid.numpy()]
    u = gather_dst_dist(dist, x_sh)
    np.testing.assert_array_equal(u.detach().numpy()[valid.numpy()], x[ei[1][eid]])
    torch.sin(u).sum().backward()
    want = np.zeros_like(x)
    np.add.at(want, ei[1], np.cos(x[ei[1]]))
    np.testing.assert_allclose(dist.unshard_nodes(x_sh.grad).numpy(), want, **TOL)

    v = torch.from_numpy(rng.normal(size=(4 * dist.e_max, 3)).astype(np.float32)) * valid[:, None]
    v.requires_grad_()
    s = edge_reduce_by_dst(dist, v)
    sum_want = np.zeros((n, 3), np.float32)
    np.add.at(sum_want, ei[1][eid], v.detach().numpy()[valid.numpy()])
    np.testing.assert_allclose(dist.unshard_nodes(s).detach().numpy(), sum_want, **TOL)
    g = torch.from_numpy(rng.normal(size=s.shape).astype(np.float32))
    (s * g).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), gather_dst_dist(dist, g).numpy())
    m = dist.unshard_nodes(edge_reduce_by_dst(dist, v.detach(), op="max")).numpy()
    jm = np.asarray(jops.segment_max(jnp.asarray(v.detach().numpy()[valid.numpy()]), jnp.asarray(ei[1][eid]), n))
    np.testing.assert_array_equal(m, jm)
    assert np.isneginf(m[np.bincount(ei[1], minlength=n) == 0]).all()


@pytest.mark.parametrize("halo", HALOS)
def test_spmm_edge_weighted_on_a_dist_graph_matches_jax(rng, halo):
    """Dynamic per-edge weights: the output and the gradients in x and in w
    against the JAX single-device op on the same dst-sorted edge order."""
    ei, _, x, n = _graph(rng)
    jadj = jgraphs.build_adjacency(ei, num_nodes=n, layout="csr")
    ei2 = np.stack([np.asarray(jadj.src), np.asarray(jadj.dst)])
    wdyn = rng.normal(size=ei2.shape[1]).astype(np.float32)
    mesh = make_mesh(axes=("data",), devices=[CPU] * 4)
    dist = partition_graph(ei2, None, num_nodes=n, mesh=mesh, halo=halo)
    x_sh = shard_node_array(dist, x, mesh).requires_grad_()
    w_t = torch.from_numpy(wdyn).requires_grad_()
    loss = torch.sin(dist.unshard_nodes(spmm_edge_weighted(dist, dist.shard_edge_array(w_t), x_sh))).sum()
    loss.backward()
    jloss = lambda w_, x_: jnp.sum(jnp.sin(jops.spmm_edge_weighted(jadj, w_, x_)))
    np.testing.assert_allclose(loss.item(), float(jloss(wdyn, x)), rtol=1e-5)
    gw, gx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(wdyn), jnp.asarray(x))
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(gw), **TOL)
    np.testing.assert_allclose(dist.unshard_nodes(x_sh.grad).numpy(), np.asarray(gx), **TOL)
    same = spmm_dist_dynw(dist, dist.shard_edge_array(w_t.detach()), x_sh.detach())
    np.testing.assert_array_equal(same.numpy(), spmm_edge_weighted(dist, dist.shard_edge_array(w_t.detach()), x_sh.detach()).numpy())


def test_with_weight_none_on_a_weighted_partition(rng):
    """Unit weights through the dynamic path, equal to the JAX unweighted
    single-device SpMM, and differentiable in x."""
    ei, w, x, n, mesh, dist, x_sh = _setup(rng, 4, "alltoall", n=64, e=400)
    unit = dist.with_weight(None)
    assert unit.unit_weight and dist.has_weight
    jadj = jgraphs.build_adjacency(ei, None, num_nodes=n, layout="csr")
    out = spmm(unit, x_sh)
    np.testing.assert_allclose(unit.unshard_nodes(out).detach().numpy(), np.asarray(jops.spmm(jadj, x)), **TOL)
    torch.sin(out).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.sin(jops.spmm(jadj, v))))(jnp.asarray(x))
    np.testing.assert_allclose(dist.unshard_nodes(x_sh.grad).numpy(), np.asarray(want), **TOL)


@pytest.mark.slow
@pytest.mark.parametrize("case", HALOS + ["fit"])
def test_port_matches_jax_shard_map(rng, case):
    """The port against the JAX package's own distributed ops under
    ``shard_map`` on the conftest's 8 virtual devices (minutes on a CPU, so
    marked slow as tests/test_parallel.py is): ``spmm_dist`` and
    ``gather_src_dist`` forward and gradient per halo, and one distributed
    ``fit`` (GCN, 8 parts) against the JAX distributed ``fit``."""
    from gnn_tpu import parallel as jpar
    from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
    from gnn_tpu.train import Config as JaxConfig
    from gnn_tpu.train import fit as jax_fit
    from gnn_tpu_torch.graphs import stochastic_block_model
    from gnn_tpu_torch.train import Config, fit

    if case == "fit":
        cfg = Config.from_dict({"model": {"name": "gcn", "hidden": 8, "dropout": 0.0}, "optim": {"lr": 0.01},
                                "train": {"epochs": 4, "eval_every": 2}, "dist": {"num_parts": 8}})
        _, _, jhist = jax_fit(JaxConfig.from_json(cfg.to_json()), jax_sbm(num_nodes=120, num_classes=3, seed=31),
                              verbose=False)
        data = stochastic_block_model(num_nodes=120, num_classes=3, seed=31)
        from gnn_tpu import nn as jnn
        from gnn_tpu.train.loop import build_model as jax_build_model
        from gnn_tpu_torch.nn import load_jax_state_dict
        from gnn_tpu_torch.train.loop import build_model

        key = jax.random.split(jax.random.PRNGKey(0))[1]  # the JAX fit's model key for train.seed 0
        jmodel = jax_build_model(JaxConfig.from_json(cfg.to_json()), data.num_features, 3, key)
        model = load_jax_state_dict(build_model(cfg, data.num_features, 3),
                                    {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()})
        _, _, thist = fit(cfg, data, model=model, device="cpu", verbose=False)
        np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
        return
    ei, w, x, n = _graph(rng)
    jmesh = jpar.make_mesh(axes=("data",))
    P = jmesh.shape["data"]
    jd = jpar.partition_graph(ei, w, num_nodes=n, mesh=jmesh, halo=case)
    jx = jpar.shard_node_array(jd, x, jmesh)
    mesh = make_mesh(axes=("data",), devices=[CPU] * P)
    dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo=case)
    for jop, op in ((lambda v: jpar.spmm_dist(jd, v, jmesh), lambda v: spmm_dist(dist, v, mesh)),
                    (lambda v: jpar.gather_src_dist(jd, v), lambda v: gather_src_dist(dist, v))):
        x_sh = shard_node_array(dist, x, mesh).requires_grad_()
        out = op(x_sh)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jop(jx)), **TOL)
        torch.sin(out).sum().backward()
        want = jax.grad(lambda v: jnp.sum(jnp.sin(jop(v))))(jx)
        np.testing.assert_allclose(x_sh.grad.numpy(), np.asarray(want), **TOL)
