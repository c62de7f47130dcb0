"""The port's partition plan, mesh and native graph core against the JAX
package's.

``gnn_tpu.parallel.partition_graph(..., num_parts=P)`` needs no mesh and no
``shard_map``, so both plans are built here from the same numpy edges and
compared element for element: ``n_max``, ``h_max``, ``e_max``, ``n_buf``, the
send tables and the edge-parallel arrays, for the three halo modes, an
uneven node count, a heavy hub and ``local_blocked``. The port builds no
dense blocks under ``local_blocked``: its local intra-window edges stay in
the local CSR, so with R = 8, whose alignment is the default's, its plan
equals the JAX plan without ``local_blocked``.
"""

import pathlib

import numpy as np
import pytest
import torch

import gnn_tpu.native as jnative
from gnn_tpu import graphs as jgraphs
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.parallel import partition_graph as jax_partition_graph
from gnn_tpu_torch import native
from gnn_tpu_torch.parallel import make_mesh, partition_graph, shard_node_array, spmm_dist
from torch_jax_graph_core import jax_graph_core  # noqa: F401  (fixture)

# the JAX package's draws and graph-core results come from its C++ library
pytestmark = pytest.mark.usefixtures("jax_graph_core")

CPU = torch.device("cpu")
PLAN = ("send_idx", "t_send_idx", "esrc_coord", "edst_row", "edge_id", "in_degree")


def _graph(kind, rng):
    if kind == "hub":  # node 0 points at half the graph and back
        n = 150
        src, dst = rng.integers(0, n, 500), rng.integers(0, n, 500)
        hub = np.arange(1, n, 2)
        src, dst = np.concatenate([src, np.zeros_like(hub), hub]), np.concatenate([dst, hub, np.zeros_like(hub)])
    else:  # 'uneven': a node count no part count divides
        n = 197 if kind == "uneven" else 96
        src, dst = rng.integers(0, n, 700), rng.integers(0, n, 700)
    ei, _ = jgraphs.coalesce(np.stack([src, dst]), num_nodes=n)
    ei, w = jgraphs.gcn_norm(np.asarray(ei), num_nodes=n)
    return np.asarray(ei), np.asarray(w), n


CASES = [
    (halo, P, kind, blocked)
    for kind in ("uneven", "hub")
    for P in (2, 4, 8)
    for halo, blocked in (("allgather", 0), ("alltoall", 0), ("overlap", 0), ("overlap", 8))
]


@pytest.mark.parametrize("halo,P,kind,blocked", CASES, ids=[f"{h}-P{p}-{k}-R{b}" for h, p, k, b in CASES])
def test_partition_plan_equals_jax(rng, halo, P, kind, blocked):
    ei, w, n = _graph(kind, rng)
    got = partition_graph(ei, w, num_nodes=n, num_parts=P, halo=halo, local_blocked=blocked)
    want = jax_partition_graph(ei, w, num_nodes=n, num_parts=P, halo=halo)
    assert not hasattr(got, "diag") and not hasattr(got, "block_rows")
    for name in ("num_parts", "n_max", "num_nodes", "halo", "h_max", "e_max", "has_weight", "n_buf"):
        assert getattr(got, name) == getattr(want, name), name
    for name in PLAN:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == tuple(b.shape), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype), err_msg=name)


@pytest.mark.parametrize("halo", ["allgather", "alltoall", "overlap"])
def test_partition_csrs_hold_every_edge_once(rng, halo):
    """The forward CSRs together hold each edge once with its weight, in
    the buffer the exchange fills; the transpose CSRs hold the transpose."""
    ei, w, n = _graph("uneven", rng)
    d = partition_graph(ei, w, num_nodes=n, num_parts=4, halo=halo)
    for adj, rem in ((d.adj, d.adj_rem), (d.t_adj, d.t_adj_rem)):
        total = adj.num_edges + (0 if rem is None else rem.num_edges)
        assert total == ei.shape[1]
        np.testing.assert_allclose(
            np.sort(np.concatenate([a.weight.numpy() for a in (adj, rem) if a is not None])), np.sort(w), rtol=0
        )
        assert adj.num_dst_nodes == 4 * d.n_max
    if halo == "overlap":  # the local product reads the owned rows only
        assert d.adj.num_src_nodes == 4 * d.n_max and d.adj_rem.num_src_nodes == 4 * 4 * d.h_max
    assert d.inc.num_edges == ei.shape[1] and d.inc.num_src_nodes == 4 * d.e_max
    if halo != "allgather":  # each recv slot a part's edges read returns to one owned row
        esrc = d.esrc_coord.numpy()
        used = sum(len(np.unique(e[(e >= d.n_max) & (e < d.n_buf)])) for e in esrc)
        assert d.send.num_edges == used and d.send.num_src_nodes == 4 * 4 * d.h_max
        assert d.exchange_idx.numel() == 4 * 4 * d.h_max


def test_partition_options_and_errors(rng):
    ei, w, n = _graph("uneven", rng)
    with pytest.raises(ValueError, match="num_parts or a mesh"):
        partition_graph(ei, w, num_nodes=n)
    with pytest.raises(ValueError, match="unknown halo"):
        partition_graph(ei, w, num_nodes=n, num_parts=2, halo="ring")
    with pytest.raises(ValueError, match="requires halo='overlap'"):
        partition_graph(ei, w, num_nodes=n, num_parts=2, halo="alltoall", local_blocked=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        partition_graph(ei, w, num_nodes=n, num_parts=2, halo="overlap", local_blocked=12)
    d = partition_graph(ei, w, num_nodes=n, num_parts=2, edge_parallel=False)
    assert d.esrc_coord is None and d.inc is None and d.e_max == 0
    with pytest.raises(ValueError, match="edge_parallel=True"):
        d.with_weight(None)
    with pytest.raises(ValueError, match="edge_parallel=False"):
        d.shard_edge_array(np.ones(ei.shape[1]))
    bf16 = partition_graph(ei, w, num_nodes=n, num_parts=2, halo="overlap", local_blocked=8, block_dtype=torch.bfloat16)
    f32 = partition_graph(ei, w, num_nodes=n, num_parts=2, halo="overlap", local_blocked=8)
    for name in ("adj", "t_adj", "adj_rem", "t_adj_rem"):  # block_dtype builds nothing
        a, b = getattr(bf16, name), getattr(f32, name)
        assert a.weight.dtype == torch.float32 and torch.equal(a.weight, b.weight), name
        assert torch.equal(a.src, b.src) and torch.equal(a.row_ptr, b.row_ptr), name
    mesh = make_mesh(axes=("data",), devices=[CPU] * 4)
    assert partition_graph(ei, w, num_nodes=n, mesh=mesh).num_parts == 4
    with pytest.raises(ValueError, match="num_parts=2"):
        partition_graph(ei, w, num_nodes=n, num_parts=2, mesh=mesh)


LOCAL = [(kind, P) for kind in ("uneven", "hub") for P in (2, 4)]


@pytest.mark.parametrize("kind,P", LOCAL, ids=[f"{k}-P{p}" for k, p in LOCAL])
def test_local_blocked_keeps_every_local_edge_in_the_csr(rng, kind, P):
    """``halo='overlap', local_blocked=8``: the local CSRs hold every edge
    whose source the destination's part owns, intra-window ones included,
    and ``spmm_dist`` with its gradient equals the same partition's
    without ``local_blocked`` bit for bit."""
    ei, w, n = _graph(kind, rng)
    mesh = make_mesh(axes=("data",), devices=[CPU] * P)
    got = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="overlap", local_blocked=8)
    want = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="overlap")
    n_max = got.n_max
    local = int(((ei[0] // n_max) == (ei[1] // n_max)).sum())
    intra = int(((ei[0] // 8) == (ei[1] // 8)).sum())
    assert intra > 0 and got.adj.num_edges == got.t_adj.num_edges == local
    assert got.adj.num_edges + got.adj_rem.num_edges == ei.shape[1]
    x = rng.normal(size=(n, 16)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(P * n_max, 16)).astype(np.float32))
    outs = []
    for dist in (got, want):
        x_sh = shard_node_array(dist, x, mesh).requires_grad_()
        out = spmm_dist(dist, x_sh, mesh)
        out.backward(g)
        outs.append((out.detach(), x_sh.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_shard_unshard_and_edge_arrays(rng):
    ei, w, n = _graph("uneven", rng)
    d = partition_graph(ei, w, num_nodes=n, num_parts=4, halo="alltoall")
    want = jax_partition_graph(ei, w, num_nodes=n, num_parts=4, halo="alltoall")
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x_sh = d.shard_nodes(torch.from_numpy(x), fill=7)
    np.testing.assert_array_equal(x_sh.numpy(), np.asarray(want.shard_nodes(x, fill=7)))
    np.testing.assert_array_equal(d.unshard_nodes(x_sh).numpy(), x)
    e = rng.normal(size=ei.shape[1]).astype(np.float32)
    np.testing.assert_array_equal(d.shard_edge_array(e, fill=-1).numpy(), np.asarray(want.shard_edge_array(e, fill=-1)))
    assert d.with_weight(None).unit_weight and d.unweighted().unit_weight and not d.unit_weight
    d0 = partition_graph(ei, None, num_nodes=n, num_parts=4)
    assert d0.with_weight(None) is d0
    with pytest.raises(ValueError, match="only None"):
        d0.with_weight(torch.ones(ei.shape[1]))
    moved = d.to(CPU)
    assert moved.device == CPU and torch.equal(moved.adj.src, d.adj.src)


def test_make_mesh():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4, "model": 1} and mesh.size == 4 and mesh.num_local_parts == 4
    assert not mesh.grouped and mesh.process_count == 1 and mesh.device == CPU
    assert make_mesh((4,), ("data",), devices=[CPU] * 4).shape == {"data": 4}
    two = make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)  # the model axis (tensor parallelism)
    assert two.shape == {"data": 2, "model": 2} and two.num_local_parts == 2 and two.model_size == 2
    assert list(two.local_shards) == [0, 1] and two.model_group is None
    with pytest.raises(ValueError, match="further axis"):
        make_mesh((2, 1, 2), ("data", "model", "extra"), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="does not match 4 devices"):
        make_mesh((8,), ("data",), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="share one device"):
        make_mesh(devices=[CPU, torch.device("meta")])


def test_make_mesh_wants_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        make_mesh()


def test_native_source_lies_in_the_port():
    """The port builds its own copy of the graph core's source, inside
    gnn_tpu_torch/, and reads no file of the JAX package."""
    src = native._SRC.resolve()
    port = pathlib.Path(native.__file__).resolve().parents[1]
    assert src.is_file() and src.is_relative_to(port) and "gnn_tpu_torch" in src.parts
    assert native.load() is native.load()


@pytest.mark.parametrize("P", [1, 3, 4, 7])
def test_native_partition_by_edges_equals_jax(rng, P):
    row_ptr = np.concatenate([[0], np.cumsum(rng.integers(0, 9, 100))])
    np.testing.assert_array_equal(native.partition_by_edges(row_ptr, P), jnative.partition_by_edges(row_ptr, P))
    with pytest.raises(ValueError, match="CSR offsets"):
        native.partition_by_edges(np.array([1, 0]), 2)


@pytest.mark.parametrize("max_size", [0, 16])
def test_native_louvain_cluster_equals_jax(max_size):
    data = jax_sbm(num_nodes=200, num_classes=4, seed=3)
    ei = np.asarray(data.edge_index)
    order, row_ptr = native.sort_edges_csr(ei[0], ei[1], 200)
    col = ei[0][order]
    got, k = native.louvain_cluster(row_ptr, col, max_size=max_size, seed=1)
    want, k_want = jnative.louvain_cluster(row_ptr, col, max_size=max_size, seed=1)
    assert k == k_want > 1
    np.testing.assert_array_equal(got, want)
    if max_size:
        assert np.bincount(got).max() <= max_size
