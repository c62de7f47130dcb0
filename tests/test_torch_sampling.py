"""The port's neighbour sampling (device sampler, hop adjacencies, the host
loader and its graph-core calls) and ``forward_sampled`` of GraphSAGE, GAT
and GIN, against gnn_tpu on the same numpy inputs.

Sampled ids, hop adjacencies, CSRs, graph-core draws and host batches are
compared exactly: the port does the JAX package's integer and float32
arithmetic on the same uniforms (fed through ``u=``) or calls the same C++
source with the same seed. ``forward_sampled``: logits and every parameter's
gradient at rtol=1e-5, atol=1e-6 (float32; the fixed-fanout rows sum at most
5 terms, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import native as jnative
from gnn_tpu import nn as jnn
from gnn_tpu.graphs import sampling as jsampling
from gnn_tpu.graphs.data import Data as JaxData
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.models import GAT as JaxGAT
from gnn_tpu.models import GIN as JaxGIN
from gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from gnn_tpu.train.host_loader import HostBatchLoader as JaxHostBatchLoader
from gnn_tpu_torch import native as tnative
from gnn_tpu_torch import nn as tnn
from gnn_tpu_torch.graphs import Data, NeighborSampler, sample_neighbors, sampling, stochastic_block_model
from gnn_tpu_torch.models import GAT, GIN, GraphSAGE
from gnn_tpu_torch.train import HostBatchLoader
from torch_jax_graph_core import jax_graph_core  # noqa: F401  (fixture)

# the JAX package's draws and graph-core results come from its C++ library
pytestmark = pytest.mark.usefixtures("jax_graph_core")

TOL = dict(rtol=1e-5, atol=1e-6)
ADJ_FIELDS = ("src", "dst", "row_ptr", "t_perm", "t_row_ptr")


def _edges_with_isolated_nodes(rng, n=60, e=240):
    """A directed edge list in which nodes 0-4 have no in-edge."""
    return np.stack([rng.integers(0, n, e), rng.integers(5, n, e)])


@pytest.fixture(scope="module")
def graph():
    """The 200-node SBM in both packages, with their samplers."""
    jd = jax_sbm(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    td = stochastic_block_model(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    return jd, td, jsampling.NeighborSampler(jd, [5, 3]), NeighborSampler(td, [5, 3])


def test_sampler_csr_equals_jax(rng):
    ei = _edges_with_isolated_nodes(rng)
    j, t = jsampling.NeighborSampler(ei, [3], num_nodes=60), NeighborSampler(ei, [3], num_nodes=60)
    assert t.row_ptr.dtype == t.col.dtype == torch.int32
    np.testing.assert_array_equal(t.row_ptr.numpy(), np.asarray(j.row_ptr))
    np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
    assert (t.fanouts, t.num_nodes) == (j.fanouts, j.num_nodes) == ([3], 60)
    # a Data works as the edge list does, and num_nodes defaults to max id + 1
    from_data = NeighborSampler(Data(edge_index=ei, num_nodes=60), [3])
    assert torch.equal(from_data.row_ptr, t.row_ptr) and torch.equal(from_data.col, t.col)
    assert NeighborSampler(ei, [3]).num_nodes == int(ei.max()) + 1
    with pytest.raises(ValueError, match="edge ids"):
        NeighborSampler(ei, [3], num_nodes=10)


@pytest.mark.parametrize("fanout", [1, 4, 7])
def test_sample_neighbors_equals_jax_on_its_uniforms(rng, fanout):
    """The JAX draw's own uniforms through ``u=``: identical ids, zero-degree
    seeds (0-4) included."""
    ei = _edges_with_isolated_nodes(rng)
    j, t = jsampling.NeighborSampler(ei, [fanout], num_nodes=60), NeighborSampler(ei, [fanout], num_nodes=60)
    seeds = np.concatenate([np.arange(8), rng.integers(0, 60, 24)])
    key = jax.random.PRNGKey(fanout)
    want = jsampling.sample_neighbors(key, j.row_ptr, j.col, jnp.asarray(seeds, jnp.int32), fanout)
    u = np.array(jax.random.uniform(key, (len(seeds), fanout)))
    got = sample_neighbors(t.row_ptr, t.col, torch.from_numpy(seeds), fanout, u=torch.from_numpy(u))
    assert got.dtype == torch.int64 and tuple(got.shape) == (len(seeds), fanout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="u must be"):
        sample_neighbors(t.row_ptr, t.col, torch.from_numpy(seeds), fanout, u=torch.zeros(3, fanout))


def test_sample_neighbors_zero_degree_samples_itself_and_draws_are_in_neighbours(rng):
    ei = _edges_with_isolated_nodes(rng)
    t = NeighborSampler(ei, [6], num_nodes=60)
    seeds = torch.arange(60)
    gen = torch.Generator().manual_seed(3)
    got = sample_neighbors(t.row_ptr, t.col, seeds, 6, generator=gen)
    assert torch.equal(got[:5], seeds[:5, None].expand(5, 6))
    in_nbrs = [set(ei[0][ei[1] == d].tolist()) for d in range(60)]
    assert all(set(got[d].tolist()) <= in_nbrs[d] for d in range(5, 60) if in_nbrs[d])
    # the same generator state gives the same draw; u = 1 - eps stays in the row
    again = sample_neighbors(t.row_ptr, t.col, seeds, 6, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, again)
    last = sample_neighbors(t.row_ptr, t.col, seeds, 6, u=torch.full((60, 6), 1.0 - 2.0**-24))
    want_last = t.col[(t.row_ptr[1:] - 1).clamp_min(0).long()].long()
    deg = t.row_ptr[1:] - t.row_ptr[:-1]
    assert torch.equal(last[:, 0], torch.where(deg > 0, want_last, seeds))


@pytest.mark.parametrize("n_dst,fanout", [(1, 1), (7, 3), (64, 5)])
def test_hop_adjacency_equals_jax(n_dst, fanout):
    j, t = jsampling._hop_adjacency(n_dst, fanout), sampling._hop_adjacency(n_dst, fanout)
    assert (t.num_src_nodes, t.num_dst_nodes, t.num_edges) == (j.num_src_nodes, j.num_dst_nodes, n_dst * fanout)
    assert t.weight is None and j.weight is None
    for name in ADJ_FIELDS:
        got = getattr(t, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, name)), err_msg=name)


@pytest.mark.parametrize("batch,fanouts", [(4, [3]), (8, [4, 2]), (5, [3, 2, 2])])
def test_adjacencies_equal_jax_outermost_first_and_are_cached(rng, batch, fanouts):
    ei = _edges_with_isolated_nodes(rng)
    j, t = jsampling.NeighborSampler(ei, fanouts, num_nodes=60), NeighborSampler(ei, fanouts, num_nodes=60)
    jadjs, tadjs = j.adjacencies(batch), t.adjacencies(batch)
    assert len(tadjs) == len(jadjs) == len(fanouts)
    assert tadjs[-1].num_dst_nodes == batch and tadjs[0].num_src_nodes == batch * int(np.prod(1 + np.array(fanouts)))
    for ja, ta in zip(jadjs, tadjs):
        assert (ta.num_src_nodes, ta.num_dst_nodes) == (ja.num_src_nodes, ja.num_dst_nodes)
        for name in ADJ_FIELDS:
            np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)), err_msg=name)
    assert t.adjacencies(batch) is tadjs
    moved = t.to("cpu")
    assert moved.adjacencies(batch) is not tadjs and torch.equal(moved.col, t.col)


def test_sample_returns_the_node_list_of_the_hop_adjacencies(graph):
    """[seeds | hop-1 neighbours | hop-2 neighbours]: every source position
    of a hop holds an in-neighbour of its destination (or the destination
    itself when it has none), as in the JAX sampler."""
    _, td, _, t = graph
    seeds = torch.arange(10, 26)
    nodes, adjs = t.sample(torch.Generator().manual_seed(0), seeds)
    assert nodes.dtype == torch.int64 and nodes.shape[0] == 16 * 6 * 4 == adjs[0].num_src_nodes
    assert torch.equal(nodes[:16], seeds) and adjs is t.adjacencies(16)
    ei = td.edge_index.numpy()
    in_nbrs = [set(ei[0][ei[1] == d].tolist()) or {d} for d in range(td.num_nodes)]
    for adj in adjs:
        src, dst = nodes[adj.src.long()].tolist(), nodes[adj.dst.long()].tolist()
        assert all(s in in_nbrs[d] for s, d in zip(src, dst))
    again, _ = t.sample(torch.Generator().manual_seed(0), seeds)
    other, _ = t.sample(torch.Generator().manual_seed(1), seeds)
    assert torch.equal(nodes, again) and not torch.equal(nodes, other)


def _transfer(jax_model, port_model):
    return tnn.load_jax_state_dict(
        port_model, {k: np.asarray(v) for k, v in jnn.state_dict(jax_model).items()}
    )


@pytest.mark.parametrize(
    "make",
    [
        lambda key: (JaxGraphSAGE(12, 16, 4, key=key, dropout=0.0), GraphSAGE(12, 16, 4, dropout=0.0)),
        lambda key: (JaxGraphSAGE(12, 16, 4, key=key, aggr="max", dropout=0.0),
                     GraphSAGE(12, 16, 4, aggr="max", dropout=0.0)),
        lambda key: (JaxGAT(12, 8, 4, key=key, heads=3, dropout=0.0), GAT(12, 8, 4, heads=3, dropout=0.0)),
        lambda key: (JaxGIN(12, 16, 4, key=key, num_layers=2), GIN(12, 16, 4, num_layers=2)),
    ],
    ids=["sage-mean", "sage-max", "gat", "gin"],
)
def test_forward_sampled_matches_jax(graph, rng, make):
    """The node list of gnn_tpu's sampler through both ``forward_sampled``,
    weights carried over: logits and parameter gradients under a random
    cotangent."""
    jd, td, jsampler, tsampler = graph
    jmodel, tmodel = make(jax.random.PRNGKey(7))
    _transfer(jmodel, tmodel)
    seeds = rng.choice(200, 32, replace=False)
    nodes, jadjs = jsampler.sample(jax.random.PRNGKey(1), jnp.asarray(seeds, jnp.int32))
    nodes = np.asarray(nodes)
    tadjs = tsampler.adjacencies(32)

    out = tmodel.forward_sampled(td.x[torch.from_numpy(nodes.copy()).long()], tadjs)
    assert tuple(out.shape) == (32, 4)
    ct = rng.normal(size=(32, 4)).astype(np.float32)

    def jax_loss(m):
        y = m.forward_sampled(jd.x[nodes], jadjs)
        return jnp.sum(y * jnp.asarray(ct)), y

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(jmodel)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    j_named = jnn.state_dict(j_grads)
    for name, p in tmodel.named_parameters():
        if p.requires_grad:  # GIN's frozen eps has no gradient
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_named[name]), err_msg=name, **TOL)


def test_gat_forward_sampled_drops_only_the_attention(graph):
    """As in the JAX package, the sampled path applies no input dropout:
    with attention dropout alone in play, a layer's input reaches ``lin``
    whole, so training mode changes the logits only through the alphas."""
    _, td, _, t = graph
    model = GAT(12, 8, 4, heads=2, dropout=0.5, generator=torch.Generator().manual_seed(0))
    nodes, adjs = t.sample(torch.Generator().manual_seed(0), torch.arange(16))
    seen = []
    hook = model.convs[0].lin.register_forward_hook(lambda mod, args, out: seen.append(args[0]))
    model.forward_sampled(td.x[nodes], adjs, generator=torch.Generator().manual_seed(1))
    hook.remove()
    assert torch.equal(seen[0], td.x[nodes])


def test_native_draws_and_degrees_equal_the_jax_package(rng):
    ei = _edges_with_isolated_nodes(rng)
    j = JaxHostBatchLoader(ei, None, None, [3], num_nodes=60)
    seeds = np.concatenate([np.arange(8), rng.integers(0, 60, 24)])
    for seed, fanout, replace in ((0, 4, True), (7, 4, True), (7, 9, False)):
        want = jnative.sample_neighbors_host(j.row_ptr, j.col, seeds, fanout, seed=seed, replace=replace)
        got = tnative.sample_neighbors_host(j.row_ptr, j.col, seeds, fanout, seed=seed, replace=replace)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert (got[:5, 0] == seeds[:5]).all() and (got[:5, 1:] == -1).all()  # no in-edge: itself, then -1
    with pytest.raises(ValueError, match="seed ids"):
        tnative.sample_neighbors_host(j.row_ptr, j.col, [60], 2)
    w = rng.random(ei.shape[1]).astype(np.float32)
    for weight in (None, w):
        got = tnative.degrees(ei[1], 60, weight)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jnative.degrees(ei[1], 60, weight))
    np.testing.assert_array_equal(tnative.degrees(ei[1], 60), np.bincount(ei[1], minlength=60))
    with pytest.raises(ValueError, match="node ids"):
        tnative.degrees([60], 60)


def test_host_batch_loader_equals_jax_over_successive_batches(rng):
    """Same C++ source, same seed schedule: identical features and labels,
    batch after batch; the hop adjacencies are the device sampler's."""
    n = 60
    ei = _edges_with_isolated_nodes(rng)
    x, y = rng.normal(size=(n, 6)).astype(np.float32), rng.integers(0, 3, n)
    j = JaxHostBatchLoader(ei, x, y, [4, 2], num_nodes=n, seed=5)
    t = HostBatchLoader(ei, x, y, [4, 2], num_nodes=n, seed=5)
    np.testing.assert_array_equal(t.row_ptr, j.row_ptr)
    np.testing.assert_array_equal(t.col, j.col)
    for _ in range(3):
        seeds = rng.integers(0, n, 8)
        (jf, jy), (tf, ty) = j.batch(seeds), t.batch(seeds)
        assert isinstance(tf, np.ndarray) and tf.shape == (8 * 5 * 3, 6)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(ty, jy)
    for ja, ta in zip(j.adjacencies(8), t.adjacencies(8)):
        for name in ADJ_FIELDS:
            np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)), err_msg=name)
    assert t.adjacencies(8) is t.adjacencies(8)


def test_host_batch_loader_reads_a_memmap(tmp_path, rng):
    n = 40
    ei = np.stack([rng.integers(0, n, 160), rng.integers(0, n, 160)])
    x = rng.normal(size=(n, 5)).astype(np.float32)
    path = tmp_path / "x.bin"
    x.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=(n, 5))
    y = rng.integers(0, 3, n)
    a = HostBatchLoader(ei, mm, y, [3], num_nodes=n, seed=1).batch(np.arange(6))
    b = HostBatchLoader(ei, x, y, [3], num_nodes=n, seed=1).batch(np.arange(6))
    assert not isinstance(a[0], np.memmap)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], y[:6])


def test_data_host_arrays_keeps_numpy_and_equals_jax(rng):
    n = 30
    ei = np.stack([rng.integers(0, n, 90), rng.integers(0, n, 90)])
    x, y = rng.normal(size=(n, 4)).astype(np.float32), rng.integers(0, 3, n)
    mask = np.arange(n) < 12
    j = JaxData(x=x, edge_index=ei, y=y, num_nodes=n, train_mask=mask, host_arrays=True)
    t = Data(x=x, edge_index=ei, y=y, num_nodes=n, train_mask=mask, host_arrays=True)
    assert t.host_arrays and t.x is x and t.edge_index.dtype == np.int32 and t.train_mask.dtype == bool
    for name in ("x", "edge_index", "y", "train_mask"):
        got, want = getattr(t, name), getattr(j, name)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert t.val_mask is None and (t.num_nodes, t.num_edges, t.num_features) == (n, 90, 4)
    with pytest.raises(ValueError, match="stays on the host"):
        t.to("cpu")
    with pytest.raises(ValueError, match="edge_index"):
        Data(edge_index=ei, num_nodes=5, host_arrays=True)
    with pytest.raises(ValueError, match="integer"):
        Data(edge_index=ei.astype(np.float32), num_nodes=n, host_arrays=True)
    # the int32 guard of gnn_tpu/graphs/data.py:103-118
    with pytest.raises(ValueError, match="exceeds int32"):
        Data(edge_index=np.zeros((2, 0), np.int64), num_nodes=2**31, host_arrays=True)
    # the host prep and the relabelling work on the numpy arrays
    adj, jadj = t.to_adjacency(norm="sym"), j.to_adjacency(norm="sym", layout="csr")
    np.testing.assert_array_equal(adj.src.numpy(), np.asarray(jadj.src))
    np.testing.assert_allclose(adj.weight.numpy(), np.asarray(jadj.weight), rtol=1e-6)
    perm = rng.permutation(n)
    moved, jmoved = t.permute_nodes(perm), j.permute_nodes(perm)
    assert isinstance(moved.x, np.ndarray) and moved.edge_index.dtype == np.int32
    np.testing.assert_array_equal(moved.x, np.asarray(jmoved.x))
    np.testing.assert_array_equal(moved.edge_index, np.asarray(jmoved.edge_index))
