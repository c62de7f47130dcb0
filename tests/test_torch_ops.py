"""The port's sparse ops against the JAX package's kernels.

On the CPU the kernel wrappers take their plain versions; those are held
against the Pallas kernels run in interpret mode (``interpret=True``, exact
float32 there) and against the XLA segment backend. Same float32 terms, only
the summation order differs, and in-degrees stay below ~50, so rtol=atol=1e-5.
The CUDA kernels themselves are compared with their plain versions on the
card in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jg
from gnn_tpu.ops import spmm as jax_spmm
from gnn_tpu.ops.pallas.segment import build_chunk_plan, segment_sum_sorted
from gnn_tpu.ops.pallas.spmm import spmm_pallas
from gnn_tpu.ops.segment import segment_sum_edges as jax_segment_sum_edges
from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch import ops as tops
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr, segment_sum_csr_plain
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph(rng, n=800, e=6000):
    """A random multigraph with self loops; the JAX adjacency gets its ELL
    layouts and chunk plans (E >= 2048), which spmm_pallas needs."""
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64)
    w = rng.normal(size=e).astype(np.float32)
    return jg.build_adjacency(ei, jnp.asarray(w), num_nodes=n), tg.build_adjacency(ei, w, num_nodes=n)


def _row_ptr(dst_sorted, n):
    return torch.from_numpy(
        np.concatenate([[0], np.cumsum(np.bincount(dst_sorted, minlength=n))]).astype(np.int32)
    )


@pytest.mark.parametrize("reference", ["pallas", "segment"])
def test_spmm_matches_jax_forward_and_grads(rng, reference):
    jadj, tadj = _graph(rng)
    n = jadj.num_dst_nodes
    x = rng.normal(size=(n, 64)).astype(np.float32)
    ct = rng.normal(size=(n, 64)).astype(np.float32)

    def jax_loss(x, weight):
        adj = jadj.replace(weight=weight)
        if reference == "pallas":
            out = spmm_pallas(adj, x, interpret=True)
        else:
            out = jax_spmm(adj, x, backend="segment")
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, j_out), (j_dx, j_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jadj.weight
    )

    xt = torch.from_numpy(x).requires_grad_()
    wt = tadj.weight.clone().requires_grad_()
    out = tops.spmm_edge_weighted(tadj, wt, xt)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(j_dw), **TOL)

    # the constant-weight path (GCNConv's) gives the same forward and dx, no dw
    xc = torch.from_numpy(x).requires_grad_()
    out_c = tops.spmm(tadj, xc)
    (out_c * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out_c.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(xc.grad.numpy(), np.asarray(j_dx), **TOL)
    assert tadj.weight.grad is None


@pytest.mark.parametrize(
    "E,N,F",
    [(3001, 500, 40), (3000, 700, 128), (1000, 2000, 64)],
    ids=["E%8!=0,F=40", "F=128", "empty_rows"],
)
def test_segment_sum_matches_pallas_kernel(rng, E, N, F):
    dst = np.sort(rng.integers(0, N, E))
    msg = rng.normal(size=(E, F)).astype(np.float32)
    plan = build_chunk_plan(dst, N, chunk=256, rows=256)
    want = np.asarray(
        segment_sum_sorted(jnp.asarray(msg), plan, N, dst_sorted=jnp.asarray(dst), interpret=True)
    )
    got = segment_sum_csr(_row_ptr(dst, N), torch.from_numpy(msg))
    assert got.shape == (N, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_versions_accumulate_bf16_in_f32(rng):
    """bf16 inputs: float32 sums of the bf16 values, one rounding at the end."""
    n, e, F = 200, 3000, 16
    dst = np.sort(rng.integers(0, n, e))
    col = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=e).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32)).to(torch.bfloat16)
    rp = _row_ptr(dst, n)
    out = csr_spmm(rp, col, w, x)
    assert out.dtype == torch.bfloat16
    want = csr_spmm_plain(rp, col, w, x.float()).to(torch.bfloat16)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    msg = x.float().repeat(e // n, 1).to(torch.bfloat16)
    seg = segment_sum_csr(rp, msg)
    torch.testing.assert_close(seg, segment_sum_csr_plain(rp, msg.float()).to(torch.bfloat16), rtol=0, atol=0)


def test_segment_sum_edges_matches_jax(rng):
    jadj, tadj = _graph(rng, n=600, e=4000)
    E, n = jadj.num_edges, jadj.num_dst_nodes
    vals = rng.normal(size=(E, 2, 8)).astype(np.float32)
    ct = rng.normal(size=(n, 2, 8)).astype(np.float32)

    def jax_loss(v):
        out = jax_segment_sum_edges(v, jadj, backend="pallas", interpret=True)
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, j_out), j_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(vals))
    vt = torch.from_numpy(vals).requires_grad_()
    out = tops.segment_sum_edges(vt, tadj)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.shape == (n, 2, 8)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(j_grad), **TOL)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_message_passing_propagate_matches_jax(rng, aggr):
    from gnn_tpu.mp import MessagePassing as JaxMessagePassing
    from gnn_tpu_torch.mp import MessagePassing

    n = 300
    ei = np.stack([rng.integers(0, n, 1500), rng.integers(0, n // 2, 1500)]).astype(np.int64)
    jadj = jg.build_adjacency(ei, num_nodes=n, layout="csr")
    tadj = tg.build_adjacency(ei, num_nodes=n)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    want = JaxMessagePassing(aggr=aggr).propagate(jadj, jnp.asarray(x))
    got = MessagePassing(aggr=aggr).propagate(tadj, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version(rng):
    jadj, tadj = _graph(rng, n=100, e=500)
    before = (csr_spmm.launches, segment_sum_csr.launches)
    x = torch.randn(100, 8)
    torch.testing.assert_close(
        csr_spmm(tadj.row_ptr, tadj.src, tadj.weight, x),
        csr_spmm_plain(tadj.row_ptr, tadj.src, tadj.weight, x),
        rtol=0, atol=0,
    )
    segment_sum_csr(tadj.row_ptr, torch.randn(500, 8))
    assert (csr_spmm.launches, segment_sum_csr.launches) == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        csr_spmm(tadj.row_ptr, tadj.src, tadj.weight, x.to("meta"))
    with pytest.raises(ValueError, match="needs an ELL layout"):  # E < 2048: the JAX adjacency has none
        tops.spmm(tadj, x, backend="ell")
    with pytest.raises(ValueError, match="rank 2"):
        tops.spmm(tadj, x[0])


def _gat_graph(rng, layout, n=300, e=3000):
    """One edge list through both packages; both sort edges by (dst, src),
    so per-edge arrays line up."""
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64)
    jadj = jg.build_adjacency(ei, num_nodes=n, layout=layout)
    tadj = tg.build_adjacency(ei, num_nodes=n)
    np.testing.assert_array_equal(np.asarray(jadj.src), tadj.src.numpy())
    np.testing.assert_array_equal(np.asarray(jadj.dst), tadj.dst.numpy())
    return jadj, tadj


def test_spmm_heads_matches_jax_segment_kernel(rng):
    """K3's plain version against GAT's numerator in the JAX package: the
    [E, H, F] messages w * h[src] through the Pallas segment sum
    (interpret mode), forward and the VJPs in h and in w."""
    from gnn_tpu_torch.ops.cuda.spmm_heads import spmm_heads_csr

    jadj, tadj = _gat_graph(rng, "ell")
    assert jadj.num_edges >= jadj.chunk_plan.chunk  # the kernel, not XLA
    n, E, H, F = jadj.num_dst_nodes, jadj.num_edges, 4, 8
    h = rng.normal(size=(n, H, F)).astype(np.float32)
    w = rng.random((E, H)).astype(np.float32)
    ct = rng.normal(size=(n, H, F)).astype(np.float32)

    def jax_num(h, w):
        msgs = w[:, :, None] * jnp.take(h, jadj.src, axis=0)
        return jax_segment_sum_edges(msgs, jadj, backend="pallas", interpret=True)

    j_out, vjp = jax.vjp(jax_num, jnp.asarray(h), jnp.asarray(w))
    j_dh, j_dw = vjp(jnp.asarray(ct))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = spmm_heads_csr(tadj, ht, wt)
    out.backward(torch.from_numpy(ct))
    assert out.shape == (n, H, F) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(j_dh), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(j_dw), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,F", [(4, 8), (1, 40), (3, 5)])
def test_spmm_heads_w_index_is_the_permuted_copy(rng, dtype, H, F):
    """w_index reads w[w_index[k]] in place: the same products in the same
    order as the call on the permuted copy w[w_index], so equal bits. The
    transpose of the training path is this with w_index = t_perm."""
    from gnn_tpu_torch.ops.cuda.spmm_heads import csr_spmm_heads, csr_spmm_heads_plain

    _, tadj = _gat_graph(rng, "csr")
    n, E = tadj.num_dst_nodes, tadj.num_edges
    w = torch.from_numpy(rng.random((E, H)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, H, F)).astype(np.float32)).to(dtype)
    t_w = w.index_select(0, tadj.t_perm.long())
    want = csr_spmm_heads_plain(tadj.t_row_ptr, tadj.t_col, t_w, g)
    for fn in (csr_spmm_heads_plain, csr_spmm_heads):
        got = fn(tadj.t_row_ptr, tadj.t_col, w, g, tadj.t_perm)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_spmm_heads_backward_transposes_through_t_perm(rng):
    """dh of spmm_heads_csr is A_w^T g: entry (s, h) sums w[e, h] * g[dst_e, h]
    over the out-edges e of s, in float64 here; rtol=1e-5 for the float32
    sums in another order."""
    from gnn_tpu_torch.ops.cuda.spmm_heads import spmm_heads_csr

    _, tadj = _gat_graph(rng, "csr")
    n, E, H, F = tadj.num_dst_nodes, tadj.num_edges, 2, 6
    w = torch.from_numpy(rng.random((E, H)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, H, F)).astype(np.float32))
    h = torch.zeros(n, H, F, requires_grad=True)
    spmm_heads_csr(tadj, h, w).backward(g)
    want = torch.zeros(n, H, F, dtype=torch.float64).index_add_(
        0, tadj.src.long(), w.double()[:, :, None] * g.double()[tadj.dst.long()]
    )
    torch.testing.assert_close(h.grad.double(), want, rtol=1e-5, atol=1e-5)


def test_spmm_heads_one_head_is_csr_spmm(rng):
    from gnn_tpu_torch.ops.cuda.spmm_heads import csr_spmm_heads_plain

    n, e, F = 200, 2500, 40
    dst = np.sort(rng.integers(0, n, e))
    rp = _row_ptr(dst, n)
    col = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    w = torch.from_numpy(rng.random(e).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32))
    got = csr_spmm_heads_plain(rp, col, w[:, None], x[:, None, :])
    torch.testing.assert_close(got[:, 0, :], csr_spmm_plain(rp, col, w, x), rtol=1e-6, atol=1e-6)


def _sddmm_graph(rng, graph, n=200, e=2500):
    """The port's adjacency of a random multigraph whose destinations skip
    every fifth node (empty rows, a row past the last edge among them), or
    of no edges."""
    if graph == "no-edges":
        return tg.build_adjacency(np.zeros((2, 0), np.int64), num_nodes=n)
    dst = rng.choice(np.flatnonzero(np.arange(n) % 5 != 4), e)
    adj = tg.build_adjacency(np.stack([rng.integers(0, n, e), dst]), num_nodes=n)
    deg = np.diff(adj.row_ptr.numpy())
    assert (deg[4::5] == 0).all() and deg[-1] == 0 and (deg[:4] > 0).all()
    return adj


@pytest.mark.parametrize("graph", ["empty-rows", "no-edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,F", [(8, 8), (1, 40), (3, 5), (4, 6)])
def test_sddmm_heads_matches_float64_einsum(rng, H, F, dtype, graph):
    """GAT's attention-weight gradient dw[e, h] = <g[dst_e, h], x[src_e, h]>:
    the plain version, the wrapper on CPU tensors and the dw of
    spmm_heads_csr's backward against an einsum in float64 over the same
    (bf16-exact) values; rtol=atol=1e-5 for float32 sums of F products."""
    from gnn_tpu_torch.ops.cuda.spmm_heads import sddmm_heads, sddmm_heads_plain, spmm_heads_csr

    adj = _sddmm_graph(rng, graph)
    n, E = adj.num_dst_nodes, adj.num_edges
    g = torch.from_numpy(rng.normal(size=(n, H, F)).astype(np.float32)).to(dtype)
    x = torch.from_numpy(rng.normal(size=(n, H, F)).astype(np.float32)).to(dtype)
    want = torch.einsum("ehf,ehf->eh", g.double()[adj.dst.long()], x.double()[adj.src.long()])
    before = sddmm_heads.launches
    for fn in (sddmm_heads_plain, sddmm_heads):
        got = fn(adj.dst, adj.src, g, x)
        assert got.dtype == torch.float32 and got.shape == (E, H)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert sddmm_heads.launches == before
    w = torch.from_numpy(rng.random((E, H)).astype(np.float32)).requires_grad_()
    out = spmm_heads_csr(adj, x, w)
    assert out.dtype == dtype
    out.backward(g)
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(w.grad.double(), want, rtol=1e-5, atol=1e-5)


def test_sddmm_heads_rejects_bad_arguments(rng):
    """The CPU wrapper checks shapes and index types before it takes the
    plain version."""
    from gnn_tpu_torch.ops.cuda.spmm_heads import sddmm_heads

    adj = _sddmm_graph(rng, "empty-rows", e=300)
    n = adj.num_dst_nodes
    g, x = torch.randn(n, 4, 8), torch.randn(n, 4, 8)
    with pytest.raises(ValueError, match="one length"):
        sddmm_heads(adj.dst, adj.src[:-1], g, x)
    with pytest.raises(ValueError, match="one \\(H, F\\)"):
        sddmm_heads(adj.dst, adj.src, torch.randn(n, 4, 6), x)
    with pytest.raises(ValueError, match="one \\(H, F\\)"):
        sddmm_heads(adj.dst, adj.src, g[:, 0], x)
    with pytest.raises(ValueError, match="dst must be a 1-D int32"):
        sddmm_heads(adj.dst.long(), adj.src, g, x)
    with pytest.raises(ValueError, match="src must be a 1-D int32"):
        sddmm_heads(adj.dst, adj.src.long(), g, x)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sddmm_heads(adj.dst.to("meta"), adj.src.to("meta"), g.to("meta"), x.to("meta"))


def test_spmm_heads_bf16_rounds_weights_like_jax(rng):
    """bf16 x: the weights are rounded to bf16 (ex_num.astype(h.dtype) in
    gnn_tpu/mp/gat.py:199), the sums are float32, the output bf16."""
    from gnn_tpu_torch.ops.cuda.spmm_heads import csr_spmm_heads

    n, e, H, F = 100, 1500, 2, 8
    dst = np.sort(rng.integers(0, n, e))
    rp = _row_ptr(dst, n)
    col = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    w = torch.from_numpy(rng.random((e, H)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, H, F)).astype(np.float32)).to(torch.bfloat16)
    before = csr_spmm_heads.launches
    out = csr_spmm_heads(rp, col, w, x)
    assert out.dtype == torch.bfloat16 and csr_spmm_heads.launches == before
    msg = w.to(torch.bfloat16).float()[:, :, None] * x.float()[col.long()]
    want = torch.zeros(n, H, F).index_add_(0, torch.from_numpy(dst), msg).to(torch.bfloat16)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["ell", "csr"])
@pytest.mark.parametrize("end", ["src", "dst"])
def test_edge_gathers_match_jax(rng, layout, end):
    """Forward and VJP of gather_{src,dst}_edges against gnn_tpu.ops.gather.
    On the CPU, 'ell' takes the JAX slot-table branch and 'csr' the
    segment_sum branch; both are the same sum (the Pallas branch is held by
    the segment_sum_edges comparisons)."""
    from gnn_tpu.ops import gather as jgather
    from gnn_tpu_torch.ops import gather_dst_edges, gather_src_edges

    jadj, tadj = _gat_graph(rng, layout)
    n, E = jadj.num_dst_nodes, jadj.num_edges
    x = rng.normal(size=(n, 2, 3)).astype(np.float32)
    ct = rng.normal(size=(E, 2, 3)).astype(np.float32)
    jfn = {"src": jgather.gather_src_edges, "dst": jgather.gather_dst_edges}[end]
    tfn = {"src": gather_src_edges, "dst": gather_dst_edges}[end]
    j_out, vjp = jax.vjp(lambda v: jfn(v, jadj), jnp.asarray(x))
    (j_dx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    out = tfn(xt, tadj)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **TOL)


def test_segment_softmax_and_normalize_match_jax(rng):
    from gnn_tpu.ops import segment as jseg

    n, e = 50, 400
    ids = np.sort(rng.integers(0, n, e))  # some segments empty
    logits = (rng.normal(size=(e, 3)) * 30).astype(np.float32)
    ct = rng.normal(size=(e, 3)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda v: jseg.segment_softmax(v, jnp.asarray(ids), n), jnp.asarray(logits))
    (j_g,) = vjp(jnp.asarray(ct))
    lt = torch.from_numpy(logits).requires_grad_()
    out = tops.segment_softmax(lt, torch.from_numpy(ids), n)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(j_g), **TOL)
    for p in (1.0, 2.0):
        want = jseg.segment_normalize(jnp.asarray(logits), jnp.asarray(ids), n, p=p)
        got = tops.segment_normalize(torch.from_numpy(logits), torch.from_numpy(ids), n, p=p)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
