"""The port's GraphSAGE and GIN families, the pools, the plain edge ops and
the small contract repairs, against gnn_tpu on the same numpy inputs.

Layers and models, with transferred weights: outputs rtol=1e-4, atol=1e-5
and every parameter's gradient rtol=1e-4, atol=1e-5 (float32; other
summation orders in the aggregation and the products). Pools, SDDMM and
gathers: rtol=1e-6, atol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jgraphs
from gnn_tpu import nn as jnn
from gnn_tpu import ops as jops
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.models import GIN as JaxGIN
from gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from gnn_tpu.mp import GINConv as JaxGINConv
from gnn_tpu.mp import SAGEConv as JaxSAGEConv
from gnn_tpu_torch import graphs as tgraphs
from gnn_tpu_torch import nn as tnn
from gnn_tpu_torch import ops as tops
from gnn_tpu_torch.graphs import stochastic_block_model
from gnn_tpu_torch.models import GIN, GraphSAGE
from gnn_tpu_torch.mp import GINConv, SAGEConv
from gnn_tpu_torch.ops.cuda import spmm as k1_module
from gnn_tpu_torch.train.metrics import Throughput

TOL = dict(rtol=1e-4, atol=1e-5)
EXACT = dict(rtol=1e-6, atol=1e-6)
KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def graph():
    """(jax data, port data) on the 200-node SBM and, by norm, the two
    packages' adjacencies: 'sym' carries the gcn_norm weights that ``fit``
    hands to every model, None has no weights."""
    jd = jax_sbm(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    td = stochastic_block_model(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    adjs = {
        norm: (jd.to_adjacency(norm=norm, layout="csr"), td.to_adjacency(norm=norm)) for norm in ("sym", None)
    }
    return jd, td, adjs


def _transfer(jax_model, port_model):
    return tnn.load_jax_state_dict(
        port_model, {k: np.asarray(v) for k, v in jnn.state_dict(jax_model).items()}
    )


def _check(jax_call, jax_model, port_call, port_model, rng, frozen=()):
    """Outputs and every parameter's gradient under a random cotangent."""
    out = port_call(port_model)
    ct = rng.normal(size=tuple(out.shape)).astype(np.float32)

    def jax_loss(m):
        y = jax_call(m)
        return jnp.sum(y * jnp.asarray(ct)), y

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_model)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    j_named = jnn.state_dict(j_grads)
    for name, p in port_model.named_parameters():
        if name in frozen:
            assert p.grad is None and not np.asarray(j_named[name]).any(), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_named[name]), err_msg=name, **TOL)


@pytest.mark.parametrize("norm", ["sym", None])
@pytest.mark.parametrize("aggr", ["mean", "sum", "max"])
def test_sageconv_matches_jax(graph, rng, aggr, norm):
    jd, td, adjs = graph
    jadj, tadj = adjs[norm]
    j = JaxSAGEConv(12, 16, key=KEY, aggr=aggr)
    t = _transfer(j, SAGEConv(12, 16, aggr=aggr))
    assert set(jnn.state_dict(j)) == set(t.state_dict())
    _check(lambda m: m(jd.x, jadj), j, lambda m: m(td.x, tadj), t, rng)


def test_sageconv_mean_divides_by_the_edge_count(graph):
    """Not by the weight sum: with gcn_norm weights the two differ."""
    _, td, adjs = graph
    _, tadj = adjs["sym"]
    conv = SAGEConv(12, 12, aggr="mean", use_bias=False)
    with torch.no_grad():
        conv.lin_self.weight.zero_()
        conv.lin_neigh.weight.copy_(torch.eye(12))
    count = (tadj.row_ptr[1:] - tadj.row_ptr[:-1]).clamp_min(1)[:, None]
    want = tops.spmm(tadj, td.x) / count
    torch.testing.assert_close(conv(td.x, tadj), want)
    by_weight = tops.segment_sum(tadj.weight, tadj.dst, tadj.num_dst_nodes)[:, None]
    assert not torch.allclose(want, tops.spmm(tadj, td.x) / by_weight, rtol=1e-2)


@pytest.mark.parametrize("aggr", ["mean", "max"])
def test_sageconv_bipartite_and_normalize_match_jax(rng, aggr):
    """A sampled hop: 30 sources, 10 destinations (one without in-edges),
    ``x_dst`` the first 10 rows; L2-normalized outputs."""
    ei = np.stack([rng.integers(0, 30, 80), rng.integers(0, 9, 80)])
    w = rng.random(80).astype(np.float32)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    jadj = jgraphs.build_adjacency(ei, w, num_src_nodes=30, num_dst_nodes=10, layout="csr")
    tadj = tgraphs.build_adjacency(ei, w, num_src_nodes=30, num_dst_nodes=10)
    j = JaxSAGEConv(6, 5, key=KEY, aggr=aggr, normalize=True)
    t = _transfer(j, SAGEConv(6, 5, aggr=aggr, normalize=True))
    tx = torch.from_numpy(x)
    _check(lambda m: m(jnp.asarray(x), jadj, jnp.asarray(x[:10])), j, lambda m: m(tx, tadj, tx[:10]), t, rng)
    out = t(tx, tadj, tx[:10])
    assert out.shape == (10, 5)
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(10))


def test_sageconv_rejects_unknown_aggr():
    with pytest.raises(ValueError, match="aggr"):
        SAGEConv(4, 4, aggr="median")


@pytest.mark.parametrize("train_eps", [False, True])
@pytest.mark.parametrize("norm", ["sym", None])
def test_ginconv_matches_jax(graph, rng, train_eps, norm):
    """At eps = 0 (the default) and, trainable, at eps = 0.3. A frozen eps
    has a zero gradient in JAX and none in the port."""
    jd, td, adjs = graph
    jadj, tadj = adjs[norm]
    eps = 0.3 if train_eps else 0.0
    j = JaxGINConv(12, [16, 16], key=KEY, eps=eps, train_eps=train_eps)
    t = _transfer(j, GINConv(12, [16, 16], eps=eps, train_eps=train_eps))
    assert set(jnn.state_dict(j)) == set(t.state_dict()) and "eps" in t.state_dict()
    assert t.eps.requires_grad == train_eps and t.eps.item() == pytest.approx(eps)
    _check(lambda m: m(jd.x, jadj), j, lambda m: m(td.x, tadj), t, rng, frozen=() if train_eps else ("eps",))


def test_ginconv_drops_the_weights_once_per_adjacency(graph):
    _, td, adjs = graph
    _, tadj = adjs["sym"]
    plain = tadj.unweighted()
    assert plain.weight is None and plain.t_weight is None and tadj.unweighted() is plain
    assert plain.unweighted() is plain and tadj.weight is not None
    conv = GINConv(12, [8, 8])
    torch.testing.assert_close(conv(td.x, tadj), conv(td.x, adjs[None][1]))


@pytest.mark.parametrize("num_layers,aggr", [(2, "mean"), (3, "mean"), (2, "sum"), (2, "max")])
def test_graphsage_matches_jax(graph, rng, num_layers, aggr):
    jd, td, adjs = graph
    jadj, tadj = adjs["sym"]
    j = JaxGraphSAGE(12, 32, 4, key=KEY, num_layers=num_layers, aggr=aggr, dropout=0.0)
    t = _transfer(j, GraphSAGE(12, 32, 4, num_layers=num_layers, aggr=aggr, dropout=0.0))
    assert {k: tuple(v.shape) for k, v in jnn.state_dict(j).items()} == {
        k: tuple(v.shape) for k, v in t.state_dict().items()
    }
    _check(lambda m: m(jd.x, jadj), j, lambda m: m(td.x, tadj), t, rng)


@pytest.mark.parametrize("num_layers,train_eps", [(2, False), (3, False), (2, True)])
def test_gin_matches_jax(graph, rng, num_layers, train_eps):
    jd, td, adjs = graph
    jadj, tadj = adjs["sym"]
    j = JaxGIN(12, 16, 4, key=KEY, num_layers=num_layers, train_eps=train_eps)
    t = _transfer(j, GIN(12, 16, 4, num_layers=num_layers, train_eps=train_eps))
    assert {k: tuple(v.shape) for k, v in jnn.state_dict(j).items()} == {
        k: tuple(v.shape) for k, v in t.state_dict().items()
    }
    frozen = () if train_eps else tuple(f"convs.{i}.eps" for i in range(num_layers))
    _check(lambda m: m(jd.x, jadj), j, lambda m: m(td.x, tadj), t, rng, frozen=frozen)


def test_models_inference_mode_matches_jax_with_dropout(graph):
    jd, td, adjs = graph
    jadj, tadj = adjs["sym"]
    j = JaxGraphSAGE(12, 16, 4, key=KEY, dropout=0.5)
    t = _transfer(j, GraphSAGE(12, 16, 4, dropout=0.5))
    a = t(td.x, tadj, generator=torch.Generator().manual_seed(0))
    b = t(td.x, tadj, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(a, b)
    want = jnn.inference_mode(j)(jd.x, jadj)
    np.testing.assert_allclose(t.eval()(td.x, tadj).detach().numpy(), np.asarray(want), **TOL)


def _two_graphs(make):
    return [make(num_nodes=20, num_classes=2, seed=31), make(num_nodes=25, num_classes=2, seed=32)]


def test_batch_matches_jax():
    jb, tb = jgraphs.Batch(_two_graphs(jax_sbm)), tgraphs.Batch(_two_graphs(stochastic_block_model))
    assert (tb.num_graphs, tb.num_nodes, tb.num_edges) == (jb.num_graphs, jb.num_nodes, jb.num_edges) == (2, 45, tb.num_edges)
    np.testing.assert_array_equal(tb.graph_id.numpy(), np.asarray(jb.graph_id))
    np.testing.assert_array_equal(tb.edge_index.numpy(), np.asarray(jb.edge_index))
    np.testing.assert_array_equal(tb.x.numpy(), np.asarray(jb.x))
    np.testing.assert_array_equal(tb.y.numpy(), np.asarray(jb.y))
    assert tb.graph_id.dtype == torch.int32 and tb.train_mask is None
    assert tb.to("cpu").graph_id is not None
    with pytest.raises(ValueError, match="at least one"):
        tgraphs.Batch([])


def test_gin_graph_level_readout_matches_jax(rng):
    """Port of tests/test_models.py::test_gin_graph_level_readout, held to
    the JAX model."""
    jb, tb = jgraphs.Batch(_two_graphs(jax_sbm)), tgraphs.Batch(_two_graphs(stochastic_block_model))
    jadj = jb.to_adjacency(norm=None, add_self_loops=False, layout="csr")
    tadj = tb.to_adjacency(norm=None, add_self_loops=False)
    j = JaxGIN(16, 8, 3, key=KEY)
    t = _transfer(j, GIN(16, 8, 3))
    frozen = ("convs.0.eps", "convs.1.eps")
    _check(
        lambda m: m(jb.x, jadj, graph_id=jb.graph_id, num_graphs=2), j,
        lambda m: m(tb.x, tadj, graph_id=tb.graph_id, num_graphs=2), t, rng, frozen=frozen,
    )
    assert t(tb.x, tadj, graph_id=tb.graph_id, num_graphs=2).shape == (2, 3)


@pytest.mark.parametrize("pool", ["global_add_pool", "global_mean_pool", "global_max_pool"])
def test_global_pools_match_jax(rng, pool):
    """Three graphs of which the middle one has no node: its row is 0."""
    x = rng.normal(size=(9, 5)).astype(np.float32)
    x[0, 0] = np.inf
    gid = np.array([0, 0, 0, 0, 2, 2, 2, 2, 2], np.int32)
    got = getattr(tops, pool)(torch.from_numpy(x), torch.from_numpy(gid), 3)
    want = getattr(jops, pool)(jnp.asarray(x), jnp.asarray(gid), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    assert (got[1] == 0).all()
    if pool == "global_max_pool":
        assert got[0, 0] == np.inf  # masked by the node counts, not by isfinite
        ints = tops.global_max_pool(torch.tensor([[3], [-7]]), torch.tensor([0, 0]), 2)
        assert ints.tolist() == [[3], [0]]


def test_sddmm_and_plain_gathers_match_jax(rng):
    src, dst = rng.integers(0, 20, 60), rng.integers(0, 15, 60)
    a, b = rng.normal(size=(15, 6)).astype(np.float32), rng.normal(size=(20, 6)).astype(np.float32)
    t = lambda v: torch.from_numpy(v)
    got = tops.sddmm(t(src), t(dst), t(a), t(b), backend="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.sddmm(src, dst, jnp.asarray(a), jnp.asarray(b))), **EXACT)
    np.testing.assert_array_equal(tops.gather_src(t(b), t(src)).numpy(), np.asarray(jops.gather_src(jnp.asarray(b), src)))
    np.testing.assert_array_equal(tops.gather_dst(t(a), t(dst)).numpy(), np.asarray(jops.gather_dst(jnp.asarray(a), dst)))


@pytest.mark.parametrize(
    "name", ["segment_sum", "segment_mean", "segment_max", "segment_min", "segment_softmax", "segment_normalize"]
)
def test_segment_ops_accept_indices_are_sorted(rng, name):
    """The JAX package's callers pass it; the port takes and ignores it."""
    data = rng.normal(size=(40, 3)).astype(np.float32)
    ids = np.sort(rng.integers(0, 8, 40)).astype(np.int32)
    got = getattr(tops, name)(torch.from_numpy(data), torch.from_numpy(ids), 8, indices_are_sorted=True)
    want = getattr(jops, name)(jnp.asarray(data), jnp.asarray(ids), 8, indices_are_sorted=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, getattr(tops, name)(torch.from_numpy(data), torch.from_numpy(ids), 8))


def test_segment_sum_edges_accepts_backend_and_interpret(graph, rng):
    _, td, adjs = graph
    _, tadj = adjs["sym"]
    v = torch.from_numpy(rng.normal(size=(tadj.num_edges, 3)).astype(np.float32))
    got = tops.segment_sum_edges(v, tadj, backend="pallas", interpret=True)
    torch.testing.assert_close(got, tops.segment_sum_edges(v, tadj))


@pytest.mark.parametrize("weighted", [False, True])
def test_add_self_loops_matches_jax(rng, weighted):
    ei = np.stack([rng.integers(0, 9, 20), rng.integers(0, 9, 20)])
    ei[:, 0] = 4  # an existing self loop gets a second one
    w = rng.random(20).astype(np.float32) if weighted else None
    got_ei, got_w = tgraphs.add_self_loops(ei, w, fill_value=2.0, num_nodes=11)
    want_ei, want_w = jgraphs.add_self_loops(ei, w, fill_value=2.0, num_nodes=11)
    np.testing.assert_array_equal(got_ei, want_ei)
    assert got_ei.shape == (2, 31) and (got_w is None) == (want_w is None)
    if weighted:
        np.testing.assert_array_equal(got_w, want_w)
    assert tgraphs.add_self_loops(ei)[0].shape == (2, 20 + int(ei.max()) + 1)


def test_throughput_steps_per_s(monkeypatch):
    from gnn_tpu_torch.train import metrics

    clock = iter([10.0, 12.0, 12.0])
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: next(clock))
    thr = Throughput(edges_per_step=1000)
    assert thr.steps_per_s == 0.0
    thr.start()  # at 10.0
    for _ in range(4):
        thr.step()
    assert thr.steps_per_s == pytest.approx(2.0)  # 4 steps in 2 s
    assert thr.edges_per_s == pytest.approx(2000.0)


@pytest.mark.parametrize(
    "y,dtype,shape",
    [
        (np.arange(5, dtype=np.int32), torch.int64, (5,)),
        (np.arange(5, dtype=np.uint8), torch.int64, (5,)),
        (np.linspace(0, 1, 5, dtype=np.float32), torch.float32, (5,)),
        (np.zeros((5, 3), np.float64), torch.float64, (5, 3)),
    ],
    ids=["int32", "uint8", "float32", "float64-2d"],
)
def test_data_keeps_float_labels(y, dtype, shape):
    """Integer labels become int64 (what cross_entropy indexes with); float
    targets (the regression losses') keep their dtype and shape."""
    d = tgraphs.Data(x=np.zeros((5, 2), np.float32), edge_index=np.zeros((2, 0), np.int64), y=y)
    assert d.y.dtype == dtype and tuple(d.y.shape) == shape
    moved = d.permute_nodes(np.array([4, 3, 2, 1, 0]))
    assert moved.y.dtype == dtype and torch.equal(moved.y, d.y.flip(0))
    if dtype.is_floating_point:
        assert tnn.mse_loss(d.y, d.y).item() == 0.0


def test_reorder_auto_keeps_node_ids_until_roadmap_item_9(graph):
    """ROADMAP Queue 1 item 9 has landed: ``reorder='auto'`` and ``True``
    relabel the nodes by degree bucket as the JAX package does, ``perm``
    element for element, and ``False`` keeps the ids. Pinned so that a later
    change to the order is made knowingly."""
    jd, td, _ = graph
    for reorder in ("auto", True):
        want = np.asarray(jd.to_adjacency(norm="sym", reorder=reorder).perm)
        got = td.to_adjacency(norm="sym", reorder=reorder).perm
        assert got is not None and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert td.to_adjacency(norm="sym", reorder=False).perm is None
    assert "item 9" not in tgraphs.build_adjacency.__doc__


@pytest.mark.parametrize(
    "call,error,match",
    [
        # forward_sampled is ported: without one adjacency per conv it raises
        # the JAX package's error (gnn_tpu/models/sage.py:70-71, gin.py:75-76)
        (lambda: GraphSAGE(4, 4, 2).forward_sampled(torch.zeros(3, 4), []), ValueError, "need 2 hop adjacencies"),
        (lambda: GIN(4, 4, 2).forward_sampled(torch.zeros(3, 4), []), ValueError, "need 2 hop adjacencies"),
        (lambda: SAGEConv(4, 4)(torch.zeros(3, 4), object()), NotImplementedError, "item 15"),
        (lambda: SAGEConv(4, 4)._forward_dist(torch.zeros(3, 4), None), NotImplementedError, "item 15"),
    ],
    ids=["sage.forward_sampled", "gin.forward_sampled", "sageconv.dist-graph", "sageconv._forward_dist"],
)
def test_unported_sage_gin_paths_raise(call, error, match):
    with pytest.raises(error, match=match):
        call()


@pytest.mark.parametrize(
    "make,calls",
    [
        (lambda: SAGEConv(12, 8, aggr="mean"), 2),
        (lambda: SAGEConv(12, 8, aggr="sum"), 2),
        (lambda: SAGEConv(12, 8, aggr="max"), 0),
        (lambda: GINConv(12, [8, 8]), 2),
        (lambda: GraphSAGE(12, 8, 4, num_layers=3, dropout=0.0), 5),
        (lambda: GIN(12, 8, 4, num_layers=3), 5),
    ],
    ids=["sage-mean", "sage-sum", "sage-max", "gin-conv", "graphsage-3", "gin-3"],
)
def test_aggregation_goes_through_the_k1_wrapper(graph, monkeypatch, make, calls):
    """sum/mean and GIN's sum reach ``csr_spmm`` (which launches K1 on a CUDA
    tensor): once forward and once backward per layer whose input needs a
    gradient. A conv alone is given an input that needs one (2 calls); in a
    model the first layer's input is the data, so L layers make L + (L - 1)
    calls. 'max' has no kernel and makes none."""
    _, td, adjs = graph
    _, tadj = adjs["sym"]
    seen = []
    inner = k1_module.csr_spmm

    def counting(row_ptr, col, weight, x):
        seen.append(weight is None)
        return inner(row_ptr, col, weight, x)

    monkeypatch.setattr(k1_module, "csr_spmm", counting)
    module = make()
    x = td.x.clone().requires_grad_(not isinstance(module, (GraphSAGE, GIN)))
    module(x, tadj).sum().backward()
    assert len(seen) == calls
    if isinstance(module, (GINConv, GIN)):
        assert all(seen)  # GIN sums with a null weight
    else:
        assert not any(seen)
