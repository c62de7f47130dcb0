"""``ops/edge_agg.py`` (CSR reductions over edge positions on K2 / K1)
against gnn_tpu's slot tables, on the same numpy inputs.

The graph has empty rows (40 nodes receive nothing) and a hub of 700
in-edges, past the JAX layout's KMAX of 512 (its hub tail). Sums and their
gradients: rtol=1e-5, atol=1e-5 (float32, another summation order; the hub
sums 700 terms). Maxima, the gradient gathers and the -inf rows: exact.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jg
from gnn_tpu import nn as jnn
from gnn_tpu.mp import GATConv as JaxGATConv
from gnn_tpu.ops import edge_agg as jea
from gnn_tpu.ops.segment import segment_sum_edges as jax_segment_sum_edges
from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch import ops as tops
from gnn_tpu_torch.mp import GATConv
from gnn_tpu_torch.nn import load_jax_state_dict
from gnn_tpu_torch.ops import edge_agg as tea
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm

TOL = dict(rtol=1e-5, atol=1e-5)
N, HUB = 300, 5


@pytest.fixture(scope="module")
def adjs():
    """(jax adjacency, port adjacency), layout 'ell' (both carry edge_agg)."""
    rng = np.random.default_rng(0)
    src = np.concatenate([rng.integers(0, N, 2500), rng.integers(0, N, 700)])
    dst = np.concatenate([rng.integers(0, N - 40, 2500), np.full(700, HUB)])
    w = rng.random(src.size).astype(np.float32)
    ei = np.stack([src, dst])
    ja = jg.build_adjacency(ei, w, num_nodes=N, layout="ell")
    ta = tg.build_adjacency(ei, w, num_nodes=N, layout="ell")
    assert ja.edge_agg is not None and ta.edge_agg is not None
    return ja, ta


@pytest.mark.parametrize("F", [1, 8])
@pytest.mark.parametrize("which", ["edge_agg", "t_edge_agg"])
def test_edge_aggregate_matches_jax(adjs, which, F):
    """Forward and gradient over the identity positions (K2's plain version)
    and over ``t_perm`` (K1's); the VJP is the gather g[edge_node]."""
    ja, ta = adjs
    E = ta.num_edges
    rng = np.random.default_rng(F)
    msg = rng.normal(size=(E, F)).astype(np.float32)
    ct = rng.normal(size=(N, F)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda m: jea.edge_aggregate(m, getattr(ja, which)), jnp.asarray(msg))
    (j_g,) = vjp(jnp.asarray(ct))
    before = (csr_spmm.launches, segment_sum_csr.launches)
    mt = torch.from_numpy(msg).requires_grad_()
    out = tea.edge_aggregate(mt, getattr(ta, which))
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(mt.grad.numpy(), np.asarray(j_g))
    assert (csr_spmm.launches, segment_sum_csr.launches) == before  # the CPU runs the plain versions
    assert not out.detach()[N - 40 :].any() if which == "edge_agg" else True


@pytest.mark.parametrize("positions", [False, True])
def test_build_edge_agg_matches_jax(adjs, positions):
    """build_edge_agg alone, from host arrays: the same sums as the JAX
    slot tables and the same per-edge node map."""
    ja, ta = adjs
    E = ta.num_edges
    if positions:
        node, pos, n = np.asarray(ja.src)[np.asarray(ja.t_perm)], np.asarray(ja.t_perm), N
    else:
        node, pos, n = np.asarray(ja.dst), None, N
    jl = jea.build_edge_agg(node, n, E, positions=pos)
    tl = tea.build_edge_agg(node, n, E, positions=pos)
    np.testing.assert_array_equal(tl.edge_node.numpy(), np.asarray(jl.edge_node))
    msg = np.random.default_rng(1).normal(size=(E, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tea.edge_aggregate(torch.from_numpy(msg), tl).numpy(),
        np.asarray(jea.edge_aggregate(jnp.asarray(msg), jl)), **TOL,
    )
    with pytest.raises(ValueError, match=f"layout built for {E} edges, got 7"):
        tea.edge_aggregate(torch.zeros(7, 3), tl)


@pytest.mark.parametrize("which", ["edge_agg", "t_edge_agg"])
def test_edge_aggregate_max_matches_jax(adjs, which):
    """-inf on rows with no edge, exact maxima elsewhere, no gradient."""
    ja, ta = adjs
    msg = np.random.default_rng(2).normal(size=(ta.num_edges, 4)).astype(np.float32)
    want = np.asarray(jea.edge_aggregate_max(jnp.asarray(msg), getattr(ja, which)))
    got = tea.edge_aggregate_max(torch.from_numpy(msg).requires_grad_(), getattr(ta, which))
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    if which == "edge_agg":
        assert np.isneginf(got.numpy()[N - 40 :]).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_agg_matvec_matches_jax(adjs, weighted):
    """The static-weight variant over the dst-sorted CSR (K1's plain
    version), and its weight refresh and transpose remap."""
    ja, _ = adjs
    E = ja.num_edges
    dst, src = np.asarray(ja.dst), np.asarray(ja.src)
    eid = np.arange(E)
    w = np.asarray(ja.weight) if weighted else None
    jl = jea.build_weighted_agg(dst, src, eid, w, N, E)
    tl = tea.build_weighted_agg(dst, src, eid, w, N, E)
    x = np.random.default_rng(3).normal(size=(N, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tea.weighted_agg_matvec(torch.from_numpy(x), tl).numpy(),
        np.asarray(jea.weighted_agg_matvec(jnp.asarray(x), jl)), **TOL,
    )
    w_ext = np.concatenate([np.random.default_rng(4).random(E), [0.0]]).astype(np.float32)
    jr = jea.refresh_weighted_agg(jl, jnp.asarray(w_ext))
    tr = tea.refresh_weighted_agg(tl, torch.from_numpy(w_ext))
    np.testing.assert_allclose(
        tea.weighted_agg_matvec(torch.from_numpy(x), tr).numpy(),
        np.asarray(jea.weighted_agg_matvec(jnp.asarray(x), jr)), **TOL,
    )
    inv_ext = np.concatenate([np.random.default_rng(5).permutation(E), [E]]).astype(np.int32)
    remapped = tea.remap_weighted_agg(tl, torch.from_numpy(inv_ext))
    np.testing.assert_array_equal(remapped.eid.numpy(), inv_ext[eid])
    assert tea.remap_weighted_agg(None, torch.from_numpy(inv_ext)) is None


def test_segment_sum_edges_agg_backend(adjs, rng):
    """backend='agg' runs K2 (its plain version here) where edge_agg is
    present, and raises the JAX package's error where it is not."""
    ja, ta = adjs
    v = rng.normal(size=(ta.num_edges, 2, 3)).astype(np.float32)
    want = jax_segment_sum_edges(jnp.asarray(v), ja, backend="agg")
    got = tops.segment_sum_edges(torch.from_numpy(v), ta, backend="agg")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ei = np.stack([rng.integers(0, 50, 300), rng.integers(0, 50, 300)])
    ja_csr, ta_csr = jg.build_adjacency(ei, num_nodes=50), tg.build_adjacency(ei, num_nodes=50)
    assert ta_csr.edge_agg is None and ja_csr.edge_agg is None
    with pytest.raises(ValueError) as err:
        jax_segment_sum_edges(jnp.zeros((300, 2)), ja_csr, backend="agg")
    with pytest.raises(ValueError, match=re.escape(str(err.value))):
        tops.segment_sum_edges(torch.zeros(300, 2), ta_csr, backend="agg")


def test_edge_agg_views_and_moves_without_copies(adjs):
    """edge_agg / t_edge_agg are views of the CSR arrays; ``to`` and
    ``transpose`` keep them so, ``with_weight`` keeps them as they are."""
    _, ta = adjs
    for adj in (ta, ta.to("cpu"), ta.transpose(), ta.with_weight(None)):
        assert adj.edge_agg.row_ptr is adj.row_ptr and adj.edge_agg.edge_node is adj.dst
        assert adj.t_edge_agg.positions is adj.t_perm and adj.t_edge_agg.edge_node is adj.src
        assert adj.edge_agg.positions is None


def test_gatconv_on_relabelled_graph_matches_jax(rng):
    """GAT's layer over a degree-bucket relabelled adjacency, where the JAX
    layer takes its softmax shift and gather VJPs through its edge_agg slot
    tables and the port through the CSRs over edge positions; forward and
    every gradient at rtol=1e-4, atol=1e-5."""
    n = 300
    ei, _ = tg.to_undirected(tg.power_law(n, 1500, seed=1), num_nodes=n)
    ei, _ = tg.add_remaining_self_loops(ei, num_nodes=n)
    ja, ta = jg.build_adjacency(ei, num_nodes=n, reorder=True), tg.build_adjacency(ei, num_nodes=n, reorder=True)
    assert ta.layout == "sorted" and ja.edge_agg is not None
    jconv = JaxGATConv(12, 8, key=jax.random.PRNGKey(3), heads=4)
    tconv = load_jax_state_dict(GATConv(12, 8, heads=4), {k: np.asarray(v) for k, v in jnn.state_dict(jconv).items()})
    x = rng.normal(size=(n, 12)).astype(np.float32)
    ct = rng.normal(size=(n, 32)).astype(np.float32)

    def loss(m, v):
        out = m(v, ja)
        return jnp.sum(out * ct), out

    (_, j_out), (j_grads, j_dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(jconv, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tconv(xt, ta)
    (out * torch.from_numpy(ct)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **tol)
    j_named = jnn.state_dict(j_grads)
    for name, p in tconv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_named[name]), err_msg=name, **tol)
