"""The bounds module (``gnn_tpu_torch.ops.cuda.bounds``): the least time an
H100 could take for a call of K1, K2, K3 or GAT's SDDMM, from its shapes.

The expected figures are counted by hand at ogbn-arxiv scale (N = 169,343
nodes, E = 2,478,219 edges with self loops): each input and output once
(``row_ptr`` 4 (N + 1) bytes, ``col`` 4 E, float32 weights, ``x`` or ``msg``,
``out``), MB of 10^6 bytes, ms at 3.35 TB/s. Integers are compared exactly,
times to rel=1e-12 (one float division).
"""

import pytest

from gnn_tpu_torch.ops.cuda import bounds

N, E = 169_343, 2_478_219
RP, COL = 4 * (N + 1), 4 * E


def _feat(rows, width, itemsize):
    return rows * width * itemsize


@pytest.mark.parametrize(
    "H,F,itemsize,mb,ms,noreuse_ms",
    [
        (8, 32, 4, 436.7, 0.130, 0.836),
        (1, 40, 4, 74.7, 0.022, 0.133),
        (8, 32, 2, 263.3, 0.079, 0.431),
        (1, 40, 2, 47.6, 0.014, 0.069),
    ],
)
def test_k3_bound_at_arxiv_scale(H, F, itemsize, mb, ms, noreuse_ms):
    b = bounds.csr_spmm_heads_bound(N, N, E, H, F, itemsize)
    fixed = RP + COL + 4 * E * H + _feat(N, H * F, itemsize)
    assert b.bytes == fixed + _feat(N, H * F, itemsize)
    assert b.noreuse_bytes == fixed + _feat(E, H * F, itemsize)
    assert b.operations == 2 * E * H * F
    assert b.bytes / 1e6 == pytest.approx(mb, abs=0.05)
    assert b.bound_ms == pytest.approx(ms, abs=5e-4) and b.bound_by == "bytes"
    assert b.noreuse_ms == pytest.approx(noreuse_ms, abs=5e-4)
    assert b.bound_ms == pytest.approx(b.bytes / 3.35e12 * 1e3, rel=1e-12)
    # the transpose also reads the int32 w_index once
    t = bounds.csr_spmm_heads_bound(N, N, E, H, F, itemsize, indexed=True)
    assert (t.bytes - b.bytes, t.noreuse_bytes - b.noreuse_bytes, t.operations) == (4 * E, 4 * E, b.operations)


@pytest.mark.parametrize(
    "H,F,itemsize,mb,ms,noreuse_ms",
    [(8, 8, 4, 185.8, 0.0555, 0.2319), (1, 40, 4, 83.9, 0.0251, 0.1353), (8, 8, 2, 142.5, 0.0425, 0.1308)],
)
def test_sddmm_bound_at_arxiv_scale(H, F, itemsize, mb, ms, noreuse_ms):
    """GAT's SDDMM: int32 dst and src, float32 dw [E, H], g and x once; without
    reuse every edge reads its x row (g's rows come in dst order)."""
    b = bounds.sddmm_heads_bound(N, N, E, H, F, itemsize)
    fixed = 2 * COL + 4 * E * H + _feat(N, H * F, itemsize)
    assert b.bytes == fixed + _feat(N, H * F, itemsize)
    assert b.noreuse_bytes == fixed + _feat(E, H * F, itemsize)
    assert b.operations == 2 * E * H * F
    assert b.bytes / 1e6 == pytest.approx(mb, abs=0.05)
    assert b.bound_ms == pytest.approx(ms, abs=5e-4) and b.bound_by == "bytes"
    assert b.noreuse_ms == pytest.approx(noreuse_ms, abs=5e-4)


@pytest.mark.parametrize(
    "H,F,mb,ms,noreuse_ms,bwd_mb,bwd_ms,bwd_noreuse_ms",
    [(8, 8, 185.8, 0.0555, 0.2319, 272.5, 0.0814, 0.4579), (1, 40, 83.9, 0.0251, 0.1353, 138.1, 0.0412, 0.2647)],
)
def test_gatv2_score_bounds_at_arxiv_scale(H, F, mb, ms, noreuse_ms, bwd_mb, bwd_ms, bwd_noreuse_ms):
    """GATv2's score, float32. Forward: int32 dst and src, s [E, H], h_src,
    h_dst and att once; without reuse every edge reads its h_src row.
    Backward: ds [E, H], h_src, h_dst, att and the edge list (src, dst)
    in, dh_src, dh_dst and datt out; without reuse each pass reads the
    other side's row an edge and the pass by source ds again."""
    W = _feat(1, H * F, 4)
    fwd = bounds.gatv2_score_bound(N, N, E, H, F)
    fixed = 2 * COL + 4 * E * H + _feat(N, H * F, 4) + W
    assert (fwd.bytes, fwd.noreuse_bytes) == (fixed + _feat(N, H * F, 4), fixed + _feat(E, H * F, 4))
    assert fwd.operations == 4 * E * H * F
    bwd = bounds.gatv2_score_bwd_bound(N, N, E, H, F)
    fixed = 4 * E * H + 2 * W + 2 * COL + 2 * _feat(N, H * F, 4)
    assert bwd.bytes == fixed + 2 * _feat(N, H * F, 4)
    assert bwd.noreuse_bytes == fixed + 2 * _feat(E, H * F, 4) + 4 * E * H
    assert bwd.operations == 8 * E * H * F
    for b, want in ((fwd, (mb, ms, noreuse_ms)), (bwd, (bwd_mb, bwd_ms, bwd_noreuse_ms))):
        assert b.bytes / 1e6 == pytest.approx(want[0], abs=0.05) and b.bound_by == "bytes"
        assert (b.bound_ms, b.noreuse_ms) == pytest.approx(want[1:], abs=5e-4)


@pytest.mark.parametrize(
    "F,itemsize,mb,ms,noreuse_ms",
    [(256, 4, 367.3, 0.110, 0.815), (40, 4, 74.7, 0.022, 0.133), (256, 2, 193.9, 0.058, 0.411)],
)
def test_k1_bound_at_arxiv_scale(F, itemsize, mb, ms, noreuse_ms):
    b = bounds.csr_spmm_bound(N, N, E, F, itemsize)
    assert b.bytes == RP + COL + 4 * E + 2 * _feat(N, F, itemsize)
    assert b.noreuse_bytes == RP + COL + 4 * E + _feat(N, F, itemsize) + _feat(E, F, itemsize)
    assert b.bytes / 1e6 == pytest.approx(mb, abs=0.05)
    assert b.bound_ms == pytest.approx(ms, abs=5e-4) and b.bound_by == "bytes"
    assert b.noreuse_ms == pytest.approx(noreuse_ms, abs=5e-4)


@pytest.mark.parametrize("width,itemsize,ms", [(8, 4, 0.028), (1, 4, 0.006), (8, 2, 0.016)])
def test_k1_bound_of_the_source_gather_vjp(width, itemsize, ms):
    """K1 over col = t_perm with w null: the [E, width] cotangent is read
    once, every row of it exactly once, so no-reuse equals compulsory."""
    b = bounds.csr_spmm_bound(N, E, E, width, itemsize, weighted=False)
    assert b.bytes == RP + COL + _feat(E, width, itemsize) + _feat(N, width, itemsize)
    assert b.noreuse_bytes == b.bytes
    assert b.bound_ms == pytest.approx(ms, abs=5e-4)


@pytest.mark.parametrize(
    "F,itemsize,mb,ms",
    [(256, 4, 2711.8, 0.8095), (8, 4, 85.4, 0.0255), (1, 4, 11.3, 0.0034), (256, 2, 1356.2, 0.4049)],
)
def test_k2_bound_at_arxiv_scale(F, itemsize, mb, ms):
    b = bounds.segment_sum_bound(N, E, F, itemsize)
    assert b.bytes == b.noreuse_bytes == RP + _feat(E, F, itemsize) + _feat(N, F, itemsize)
    assert b.operations == E * F
    assert b.bytes / 1e6 == pytest.approx(mb, abs=0.05)
    assert b.bound_ms == b.noreuse_ms == pytest.approx(ms, abs=5e-4)
    assert b.bound_by == "bytes"


@pytest.mark.parametrize("F,itemsize", [(40, 4), (256, 4), (40, 2)])
def test_k3_at_one_head_is_k1_with_weights(F, itemsize):
    assert bounds.csr_spmm_heads_bound(N, N, E, 1, F, itemsize) == bounds.csr_spmm_bound(N, N, E, F, itemsize)


def test_bound_by_operations_when_bytes_are_few():
    """Operations bound a call only where it does more than 20 of them a
    byte (67 TFLOP/s over 3.35 TB/s); the CSR kernels never do, but the rule
    is the larger of the two times."""
    b = bounds.Bound(bytes=1_000, noreuse_bytes=2_000, operations=10**9)
    assert b.bound_by == "operations"
    assert b.bound_ms == b.noreuse_ms == pytest.approx(10**9 / 67e12 * 1e3, rel=1e-12)
    assert bounds.Bound(bytes=10**9, noreuse_bytes=10**9, operations=1).bound_by == "bytes"


@pytest.mark.parametrize(
    "n_dst,fanout,F",
    [(180_224, 5, 128), (16_384, 10, 256), (11_264, 5, 256)],
    ids=["sage-outer-hop", "sage-middle-hop", "gat-outer-hop"],
)
def test_hop_bounds_have_no_gap_forward_and_a_fanout_gap_backward(n_dst, fanout, F):
    """A sampled hop's ``col`` names each of its E = n_dst * fanout source
    rows once, in order, so the forward gather is a streamed read: the
    no-reuse figure equals the compulsory bound. Its transpose gathers each
    of the n_dst cotangent rows ``fanout`` times."""
    e = n_dst * fanout
    fwd = bounds.csr_spmm_bound(n_dst, n_dst + e, e, F, 4, weighted=False)
    assert fwd.noreuse_bytes == fwd.bytes and fwd.noreuse_ms == fwd.bound_ms
    assert fwd.bytes == 4 * (n_dst + 1 + e) + 4 * F * (2 * n_dst + e)
    dx = bounds.csr_spmm_bound(n_dst + e, n_dst, e, F, 4, weighted=False)
    assert dx.noreuse_bytes - dx.bytes == 4 * F * (e - n_dst)
    heads = bounds.csr_spmm_heads_bound(n_dst, n_dst + e, e, 8, F // 8, 4)
    assert heads.noreuse_bytes == heads.bytes == fwd.bytes + 32 * e
