"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each skips without a CUDA device. Run on a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

This file imports no jax; where jax is missing, add ``--noconftest`` (the
suite's conftest imports it).
"""

import numpy as np
import pytest
import torch

from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch import ops as tops
from gnn_tpu_torch.ops.cuda.edge_softmax import (
    edge_softmax, edge_softmax_bwd, edge_softmax_bwd_plain, edge_softmax_parts, edge_softmax_plain,
)
from gnn_tpu_torch.ops.cuda.adam import adam_update, adam_update_plain
from gnn_tpu_torch.ops.cuda.gat_score import gat_score, gat_score_bwd, gat_score_bwd_plain, gat_score_plain
from gnn_tpu_torch.ops.cuda.gatv2_score import gatv2_score, gatv2_score_bwd, gatv2_score_bwd_plain, gatv2_score_plain
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr, segment_sum_csr_plain
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain
from gnn_tpu_torch.ops.cuda.spmm_heads import csr_spmm_heads, csr_spmm_heads_plain, sddmm_heads, sddmm_heads_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _misaligned(n, f, dtype, device):
    """A contiguous [n, f] tensor whose base is off the vector-load boundary."""
    return torch.randn(n * f + 1, device=device).to(dtype)[1:].view(n, f)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,aligned", [(64, True), (40, True), (37, True), (64, False)])
def test_kernels_match_plain_versions_on_card(cuda_device, dtype, F, aligned):
    """A power-law graph with GCN weights, as on the main path. Float32:
    rtol=atol=1e-4 (hub rows sum thousands of terms in another order).
    bfloat16: both sum the same bf16 values in float32 and round once, so
    they are one bf16 rounding apart (rtol=2e-2), plus the float32 order
    error of sums that cancel to near zero (atol=1e-3)."""
    n = 3000
    ei, _ = tg.to_undirected(tg.power_law(n, 40000, seed=0), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    adj = tg.build_adjacency(ei, w, num_nodes=n).to(cuda_device)
    e = adj.num_edges
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=1e-3)
    x = torch.randn(n, F, device=cuda_device).to(dtype) if aligned else _misaligned(n, F, dtype, cuda_device)
    msg = torch.randn(e, F, device=cuda_device).to(dtype)
    k1, k2 = csr_spmm.launches, segment_sum_csr.launches
    for weight in (adj.weight, None):
        got = csr_spmm(adj.row_ptr, adj.src, weight, x)
        want = csr_spmm_plain(adj.row_ptr, adj.src, weight, x)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    got = segment_sum_csr(adj.row_ptr, msg)
    torch.testing.assert_close(got.float(), segment_sum_csr_plain(adj.row_ptr, msg).float(), **tol)
    xr = x.clone().requires_grad_()
    g = torch.randn(n, F, device=cuda_device).to(dtype)
    tops.spmm(adj, xr).backward(g)
    torch.testing.assert_close(
        xr.grad.float(), csr_spmm_plain(adj.t_row_ptr, adj.t_col, adj.t_weight, g).float(), **tol
    )
    torch.cuda.synchronize()
    assert csr_spmm.launches - k1 == 4 and segment_sum_csr.launches - k2 == 1


def _tolerance(dtype):
    """As in chip_smoke.py. Float32: long rows sum thousands of terms in
    another order than the plain version's index_add_. bfloat16: both sum the
    same bf16 values in float32 and round once, so they are one bf16 rounding
    apart (rtol=2e-2), plus the float32 order error of sums that cancel to
    near zero (atol=1e-3)."""
    return dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=1e-3)


def _check_deterministic(kernel, plain, args, dtype):
    """The kernel twice (bitwise equal: no atomics) against its plain version."""
    got = kernel(*args)
    assert torch.equal(got, kernel(*args))
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), plain(*args).float(), **_tolerance(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 2, 8, 40])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_merge_path_kernels_at_narrow_widths_on_card(cuda_device, dtype, F, aligned):
    """K1 (with weights, with w=None, and over col = t_perm as the source
    gather's VJP) and K2 at GAT's widths and a few others, where lane groups
    smaller than a warp take one edge each; two calls give equal bits, and
    each wrapper call counts one launch."""
    n = 3000
    ei, _ = tg.to_undirected(tg.power_law(n, 40000, seed=2), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    adj = tg.build_adjacency(ei, w, num_nodes=n).to(cuda_device)
    make = (lambda r, c: torch.randn(r, c, device=cuda_device).to(dtype)) if aligned else (
        lambda r, c: _misaligned(r, c, dtype, cuda_device))
    x, ge, msg = make(n, F), make(adj.num_edges, F), make(adj.num_edges, F)
    k1, k2 = csr_spmm.launches, segment_sum_csr.launches
    for args in ((adj.row_ptr, adj.src, adj.weight, x), (adj.row_ptr, adj.src, None, x),
                 (adj.t_row_ptr, adj.t_perm, None, ge)):
        _check_deterministic(csr_spmm, csr_spmm_plain, args, dtype)
    _check_deterministic(segment_sum_csr, segment_sum_csr_plain, (adj.row_ptr, msg), dtype)
    torch.cuda.synchronize()
    assert (csr_spmm.launches - k1, segment_sum_csr.launches - k2) == (6, 2)


# Degrees of the rows of hand-made CSRs. "star": an empty row, 20 rows of
# 255 edges (each row's last edge closes a 256-item warp tile, so its row end
# opens the next one), a 60,000-edge hub, 100 empty rows, 50 short rows.
# "tile-ends": rows of 255 edges whose row ends each close a warp tile.
# "no-edges": 500 empty rows.
_SKEWED_DEGREES = {
    "star": [0] + [255] * 20 + [60_000] + [0] * 100 + [3] * 50,
    "tile-ends": [255] * 40,
    "no-edges": [0] * 500,
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(_SKEWED_DEGREES))
def test_merge_path_kernels_on_skewed_rows_on_card(cuda_device, dtype, layout):
    """Rows much longer than a tile, rows that end exactly on a tile
    boundary, empty rows and a graph with no edges, through K1 and K2 at
    widths 1, 8 and 64. Features and weights are positive, so the hub's
    60,000-term sums do not cancel and the two summation orders agree to a
    relative float32 error (as with chip_smoke.py's positive cotangents)."""
    rng = np.random.default_rng(0)
    deg = np.asarray(_SKEWED_DEGREES[layout])
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    ends = row_ptr[1:] + np.arange(deg.size)  # merge position of each row end
    if layout == "star":
        assert (ends[1:21] % 256 == 0).all() and deg.max() > 50_000
    if layout == "tile-ends":
        assert (ends % 256 == 255).all()
    e, n_src = int(row_ptr[-1]), 1000
    as_dev = lambda a: torch.from_numpy(a).to(cuda_device)
    rp = as_dev(row_ptr.astype(np.int32))
    col = as_dev(rng.integers(0, n_src, e).astype(np.int32))
    w = as_dev(rng.random(e).astype(np.float32))
    for F in (1, 8, 64):
        x = as_dev(rng.random((n_src, F), dtype=np.float32)).to(dtype)
        msg = as_dev(rng.random((e, F), dtype=np.float32)).to(dtype)
        k1, k2 = csr_spmm.launches, segment_sum_csr.launches
        _check_deterministic(csr_spmm, csr_spmm_plain, (rp, col, w, x), dtype)
        _check_deterministic(csr_spmm, csr_spmm_plain, (rp, col, None, x), dtype)
        _check_deterministic(segment_sum_csr, segment_sum_csr_plain, (rp, msg), dtype)
        torch.cuda.synchronize()
        assert (csr_spmm.launches - k1, segment_sum_csr.launches - k2) == (4, 2)


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_arguments(cuda_device):
    rp = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda_device)
    col = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    x = torch.randn(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        csr_spmm(rp.long(), col, None, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        csr_spmm(rp, col, None, x.half())
    with pytest.raises(ValueError, match="contiguous"):
        csr_spmm(rp, col, None, x.t())
    with pytest.raises(ValueError, match="is on cpu"):
        segment_sum_csr(rp.cpu(), x)


def _attention_graph(device, n=3000):
    """A power-law graph with self loops, the shape of GAT's adjacency."""
    ei, _ = tg.to_undirected(tg.power_law(n, 40000, seed=1), num_nodes=n)
    ei, _ = tg.add_remaining_self_loops(ei, num_nodes=n)
    return tg.build_adjacency(ei, num_nodes=n).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "H,F,aligned",
    [(8, 32, True), (1, 40, True), (3, 5, True), (4, 8, False), (8, 1, True), (1, 1, True), (2, 2, True)],
)
def test_spmm_heads_matches_plain_version_on_card(cuda_device, dtype, H, F, aligned):
    """K3 forward and transpose against its plain version, with weights
    normalized per destination as GAT's attention is (so the sums stay
    O(1)); tolerances as for K1 above. The transpose reads its weights in
    place through w_index = t_perm and gives the bits of the call on the
    permuted copy; two calls give equal bits; each call counts one launch."""
    adj = _attention_graph(cuda_device)
    n, e = adj.num_dst_nodes, adj.num_edges
    w = torch.rand(e, H, device=cuda_device)
    w = w / tops.segment_sum(w, adj.dst, n).index_select(0, adj.dst.long())
    x = (torch.randn(n, H, F, device=cuda_device).to(dtype) if aligned
         else _misaligned(n, H * F, dtype, cuda_device).view(n, H, F))
    k3 = csr_spmm_heads.launches
    got = csr_spmm_heads(adj.row_ptr, adj.src, w, x)
    assert got.shape == (n, H, F)
    _check_deterministic(csr_spmm_heads, csr_spmm_heads_plain, (adj.row_ptr, adj.src, w, x), dtype)
    t_args = (adj.t_row_ptr, adj.t_col, w, x, adj.t_perm)
    _check_deterministic(csr_spmm_heads, csr_spmm_heads_plain, t_args, dtype)
    t_w = w.index_select(0, adj.t_perm.long())
    assert torch.equal(csr_spmm_heads(adj.t_row_ptr, adj.t_col, t_w, x), csr_spmm_heads(*t_args))
    torch.cuda.synchronize()
    assert csr_spmm_heads.launches - k3 == 7


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(_SKEWED_DEGREES))
def test_spmm_heads_on_skewed_rows_on_card(cuda_device, dtype, layout):
    """K3 on the hand-made CSRs above (a hub much longer than a tile, rows
    that end on tile boundaries, empty rows, no edges), so that whole rows,
    head and tail partials and the fixup all run, at GAT's shapes, on the
    scalar path (3, 5) and at widths below a warp; with and without
    w_index. Positive features and weights, as for K1 and K2 above."""
    rng = np.random.default_rng(1)
    deg = np.asarray(_SKEWED_DEGREES[layout])
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    e, n_src = int(row_ptr[-1]), 1000
    as_dev = lambda a: torch.from_numpy(a).to(cuda_device)
    rp = as_dev(row_ptr.astype(np.int32))
    col = as_dev(rng.integers(0, n_src, e).astype(np.int32))
    w_index = as_dev(rng.permutation(e).astype(np.int32))
    for H, F in ((8, 32), (1, 40), (3, 5), (8, 1), (2, 4)):
        w = as_dev(rng.random((e, H)).astype(np.float32))
        x = as_dev(rng.random((n_src, H, F), dtype=np.float32)).to(dtype)
        k3 = csr_spmm_heads.launches
        _check_deterministic(csr_spmm_heads, csr_spmm_heads_plain, (rp, col, w, x), dtype)
        _check_deterministic(csr_spmm_heads, csr_spmm_heads_plain, (rp, col, w, x, w_index), dtype)
        torch.cuda.synchronize()
        assert csr_spmm_heads.launches - k3 == 4


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["power-law", "star"])
@pytest.mark.parametrize("F", [1, 5, 40, 256])
def test_spmm_heads_one_head_is_csr_spmm_on_card(cuda_device, layout, F):
    """With one head K3 sums the products of K1 in K1's order: equal bits
    (float32; in bfloat16 K3 alone rounds its weights)."""
    if layout == "power-law":
        adj = _attention_graph(cuda_device)
        rp, col, n_src = adj.row_ptr, adj.src, adj.num_dst_nodes
    else:
        deg = np.asarray(_SKEWED_DEGREES[layout])
        rp = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)).to(cuda_device)
        n_src = 1000
        col = torch.randint(0, n_src, (int(deg.sum()),), dtype=torch.int32, device=cuda_device)
    w = torch.rand(col.numel(), device=cuda_device)
    x = torch.rand(n_src, F, device=cuda_device)
    got = csr_spmm_heads(rp, col, w[:, None], x[:, None, :])
    assert torch.equal(got[:, 0, :], csr_spmm(rp, col, w, x))


@pytest.mark.gpu
def test_spmm_heads_rejects_bad_arguments(cuda_device):
    rp = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda_device)
    col = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    x = torch.randn(2, 4, 8, device=cuda_device)
    w = torch.rand(2, 4, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        csr_spmm_heads(rp, col, torch.rand(4, 2, device=cuda_device).t(), x)
    with pytest.raises(ValueError, match="contiguous float32"):
        csr_spmm_heads(rp, col, w[:, :2].contiguous(), x)
    with pytest.raises(ValueError, match="contiguous float32"):
        csr_spmm_heads(rp, col, w.double(), x)
    with pytest.raises(ValueError, match=r"\[N, H, F\]"):
        csr_spmm_heads(rp, col, w, x[:, 0])
    with pytest.raises(ValueError, match="w_index.*int32"):
        csr_spmm_heads(rp, col, w, x, col.long())
    with pytest.raises(ValueError, match="w_index must have 2 entries"):
        csr_spmm_heads(rp, col, w, x, rp)
    with pytest.raises(ValueError, match="is on cpu"):
        csr_spmm_heads(rp, col, w.cpu(), x)


# (H, F) of the SDDMM's card tests: the GAT cells' two layers (8, 8) and
# (1, 40), the scalar path (3, 5) and (4, 6), and the 8 x 32 of chip_smoke.py
_SDDMM_HEADS = ((8, 8), (1, 40), (3, 5), (4, 6), (8, 32))


def _check_sddmm(dst, src, g, x):
    """GAT's SDDMM on the card against its plain version, twice (bitwise
    equal: no atomics), one launch a call where there are edges. Both sum
    float32 products of the same values in another order: rtol=atol=1e-5."""
    before = sddmm_heads.launches
    got = sddmm_heads(dst, src, g, x)
    assert torch.equal(got, sddmm_heads(dst, src, g, x))
    assert got.dtype == torch.float32 and got.shape == (dst.numel(), g.shape[1])
    torch.testing.assert_close(got, sddmm_heads_plain(dst, src, g, x), rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert sddmm_heads.launches - before == (2 if dst.numel() else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["power-law"] + list(_SKEWED_DEGREES))
def test_sddmm_heads_matches_plain_version_on_card(cuda_device, dtype, layout):
    """The SDDMM over the GAT adjacency of a power-law graph (where a
    misaligned g and x also take the scalar path) and over the hand-made
    CSRs above: a 60,000-edge hub, rows on tile boundaries, empty rows, no
    edges."""
    rng = np.random.default_rng(3)
    as_dev = lambda a: torch.from_numpy(a).to(cuda_device)
    if layout == "power-law":
        adj = _attention_graph(cuda_device)
        dst, src, n_dst, n_src = adj.dst, adj.src, adj.num_dst_nodes, adj.num_dst_nodes
    else:
        deg = np.asarray(_SKEWED_DEGREES[layout])
        n_dst, n_src = deg.size, 1000
        dst = as_dev(np.repeat(np.arange(n_dst), deg).astype(np.int32))
        src = as_dev(rng.integers(0, n_src, dst.numel()).astype(np.int32))
    for H, F in _SDDMM_HEADS:
        g = as_dev(rng.normal(size=(n_dst, H, F)).astype(np.float32)).to(dtype)
        x = as_dev(rng.normal(size=(n_src, H, F)).astype(np.float32)).to(dtype)
        _check_sddmm(dst, src, g, x)
        if layout == "power-law" and F % 4 == 0:
            gm = _misaligned(n_dst, H * F, dtype, cuda_device).view(n_dst, H, F)
            xm = _misaligned(n_src, H * F, dtype, cuda_device).view(n_src, H, F)
            _check_sddmm(dst, src, gm, xm)


@pytest.mark.gpu
def test_sddmm_heads_rejects_bad_arguments(cuda_device):
    dst = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    src = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    g = torch.randn(2, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous 2-D"):
        sddmm_heads(dst, src, g.transpose(1, 2).contiguous().transpose(1, 2), g)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sddmm_heads(dst, src, g.half(), g.half())
    with pytest.raises(ValueError, match="one dtype"):
        sddmm_heads(dst, src, g.bfloat16(), g)
    with pytest.raises(ValueError, match="g is on cpu"):
        sddmm_heads(dst, src, g.cpu(), g)
    with pytest.raises(ValueError, match="src is on cpu"):
        sddmm_heads(dst, src.cpu(), g, g)
    with pytest.raises(ValueError, match="dst must be a 1-D int32"):
        sddmm_heads(dst.long(), src, g, g)
    with pytest.raises(ValueError, match="one length"):
        sddmm_heads(dst, src[:1], g, g)
    with pytest.raises(ValueError, match="one \\(H, F\\)"):
        sddmm_heads(dst, src, g[:, :2], g)


@pytest.mark.gpu
def test_gat_on_card_matches_cpu(cuda_device):
    """A training step of the 2-layer GAT (4 heads x 8, then 1 head over 4
    classes) on the card (K1, K2, K3, the SDDMM and the softmax) against the
    same model on the CPU (plain versions): output, input gradient and every
    parameter's gradient, and the launches of each: K3 forward and dh, the
    SDDMM, the softmax's two kernels and the score's two C entries once a
    layer; K1 and K2 run inside the score's backward entry, not through
    their own wrappers."""
    from gnn_tpu_torch.models import GAT

    adj = _attention_graph("cpu", n=2000)
    x = torch.randn(adj.num_dst_nodes, 16)
    model_cpu = GAT(16, 8, 4, heads=4, dropout=0.0, generator=torch.Generator().manual_seed(0))
    model_gpu = GAT(16, 8, 4, heads=4, dropout=0.0).to(cuda_device)
    model_gpu.load_state_dict(model_cpu.state_dict())
    counters = (csr_spmm, segment_sum_csr, csr_spmm_heads, sddmm_heads, edge_softmax, edge_softmax_bwd, gat_score,
                gat_score_bwd)
    before = tuple(c.launches for c in counters)
    outs = []
    for model, a, xx in ((model_cpu, adj, x), (model_gpu, adj.to(cuda_device), x.to(cuda_device))):
        xx = xx.clone().requires_grad_()
        out = model(xx, a)
        (out ** 2).sum().backward()
        outs.append((out.detach().cpu(), xx.grad.cpu(), [p.grad.cpu() for p in model.parameters()]))
    torch.cuda.synchronize()
    after = tuple(c.launches for c in counters)
    assert tuple(b - a for a, b in zip(before, after)) == (0, 0, 4, 2, 2, 2, 2, 2)
    (o_c, dx_c, g_c), (o_g, dx_g, g_g) = outs
    torch.testing.assert_close(o_g, o_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx_g, dx_c, rtol=1e-4, atol=1e-4)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("H,F", [(8, 8), (1, 40), (3, 5)])
@pytest.mark.parametrize("round_src", [False, True])
def test_gat_score_matches_plain_version_on_card(cuda_device, H, F, round_src):
    """GAT's score forward (node scores and edge scores) and backward (dh and
    both attention vectors' gradients, through K2 and K1) over the attention
    graph against the plain versions: each twice bitwise alike, one launch
    of each a call; rtol 1e-5 forward (the node scores' F products in
    another order), 1e-4 backward (hub rows sum thousands of terms in
    another order)."""
    adj = _attention_graph(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    h = torch.randn(adj.num_src_nodes, H, F, device=cuda_device, generator=gen)
    att_src, att_dst = (torch.randn(H, F, device=cuda_device, generator=gen) for _ in range(2))
    de = torch.randn(adj.num_edges, H, device=cuda_device, generator=gen)
    csr = (adj.dst, adj.src, adj.row_ptr, adj.t_row_ptr, adj.t_perm)
    before = (gat_score.launches, gat_score_bwd.launches)
    e, a = gat_score(h, att_src, att_dst, adj.dst, adj.src, 0.2, round_src)
    again = gat_score(h, att_src, att_dst, adj.dst, adj.src, 0.2, round_src)
    assert torch.equal(e, again[0]) and torch.equal(a, again[1])
    want_e, want_a = gat_score_plain(h, att_src, att_dst, adj.dst, adj.src, 0.2, round_src)
    torch.testing.assert_close(a, want_a, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(e, want_e, rtol=1e-5, atol=1e-5)
    grads = gat_score_bwd(de, h, att_src, att_dst, *csr, 0.2, round_src)
    for got, again in zip(grads, gat_score_bwd(de, h, att_src, att_dst, *csr, 0.2, round_src)):
        assert torch.equal(got, again)
    for got, want in zip(grads, gat_score_bwd_plain(de, h, att_src, att_dst, *csr, 0.2, round_src)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
    assert (gat_score.launches - before[0], gat_score_bwd.launches - before[1]) == (2, 2)
    with pytest.raises(ValueError, match="contiguous 1-D int32"):
        gat_score(h, att_src, att_dst, adj.dst.long(), adj.src)
    with pytest.raises(ValueError, match="contiguous float32"):
        gat_score(h.double(), att_src.double(), att_dst.double(), adj.dst, adj.src)


@pytest.mark.gpu
@pytest.mark.parametrize("decoupled,wd", [(False, 5e-4), (True, 1e-2), (False, 0.0)])
def test_adam_kernel_matches_foreach_ops_on_card(cuda_device, decoupled, wd):
    """Adam's one-launch update against its foreach ops over 40 leaves of
    mixed sizes (two launches of 32 leaves at most), three steps: the
    moments bitwise, the parameters within an ulp's rounding of the
    quotients (rtol 1e-6); a launch a call, and the foreach ops for a
    bfloat16 leaf."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = [(128, 64), (8, 8), (64,), (1,), (33, 7)] * 8
    ps = [torch.randn(s, device=cuda_device, generator=gen) for s in shapes]
    state = [[p.clone() for p in ps], [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]]
    plain = [[p.clone() for p in ps], [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]]
    before = adam_update.launches
    for step in (1, 2, 3):
        gs = [torch.randn(s, device=cuda_device, generator=gen) for s in shapes]
        bc1, bc2 = float(np.float32(1) - np.float32(0.9) ** step), float(np.float32(1) - np.float32(0.999) ** step)
        scalars = (0.9, 1 - 0.9, 0.999, 1 - 0.999, bc1, bc2, 1e-8, -0.005, wd, 0.005 * wd)
        adam_update(state[0], gs, state[1], state[2], scalars, decoupled)
        adam_update_plain(plain[0], gs, plain[1], plain[2], scalars, decoupled)
    torch.cuda.synchronize()
    assert adam_update.launches - before == 3
    for got, want in zip(state[1] + state[2], plain[1] + plain[2]):
        assert torch.equal(got, want)
    for got, want in zip(state[0], plain[0]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    half = [torch.randn(4, device=cuda_device).bfloat16()]
    before = adam_update.launches
    adam_update(half, [torch.ones_like(half[0])], [torch.zeros_like(half[0])], [torch.zeros_like(half[0])],
                scalars, decoupled)
    assert adam_update.launches == before


# (H, F) of GATv2's score on the card: the benchmark's two layers (8, 8) and
# (1, 40), the scalar path (3, 5) and (4, 6), and the 8 x 32 of chip_smoke.py
_GATV2_HEADS = ((8, 8), (1, 40), (3, 5), (4, 6), (8, 32))


def _transpose(dst, src, n_src):
    """(t_row_ptr, t_perm, t_col) of the dst-sorted edges (dst, src), as
    ``build_adjacency`` makes them."""
    t_perm = np.lexsort((dst, src))
    t_row_ptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n_src))])
    return [a.astype(np.int32) for a in (t_row_ptr, t_perm, dst[t_perm])]


def _check_gatv2(csr, h_src, h_dst, att):
    """GATv2's score kernels on the card, each twice (bitwise equal: no
    atomics), against their plain versions in float64, one launch of each a
    call where there are edges. ``att`` and ``ds`` are signed, as a softmax's
    gradient is. The scores sum F float32 terms: rtol=atol=1e-5 per score.
    The backward's sums run over whole rows (60,000 edges at the hub) and
    cancel, so a single entry can keep little of its terms' size; each output
    is held to a relative Frobenius error of 1e-5, float32 rounding of such
    sums being a few 1e-7 of the norm."""
    row_ptr, src, dst, t_row_ptr, t_perm, t_col = csr
    wide = [t.double() for t in (h_src, h_dst, att)]
    before = (gatv2_score.launches, gatv2_score_bwd.launches)
    s = gatv2_score(h_src, h_dst, att, src, dst)
    assert torch.equal(s, gatv2_score(h_src, h_dst, att, src, dst))
    torch.testing.assert_close(s.double(), gatv2_score_plain(*wide, src, dst), rtol=1e-5, atol=1e-5)
    ds = torch.randn(s.shape, device=s.device)
    args = (ds, h_src, h_dst, att, row_ptr, src, t_row_ptr, t_perm, t_col)
    got = gatv2_score_bwd(*args)
    for a, b in zip(got, gatv2_score_bwd(*args)):
        assert torch.equal(a, b)
    for name, a, b in zip(("dh_src", "dh_dst", "datt"), got, gatv2_score_bwd_plain(ds.double(), *wide, row_ptr, src)):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        err = ((a.double() - b).norm() / b.norm().clamp_min(1e-30)).item()
        assert err <= 1e-5, f"{name}: relative Frobenius error {err:.3e}"
    torch.cuda.synchronize()
    edges = int(src.numel() > 0)
    assert (gatv2_score.launches - before[0], gatv2_score_bwd.launches - before[1]) == (2 * edges, 2 * edges)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["power-law"] + list(_SKEWED_DEGREES))
def test_gatv2_score_matches_plain_version_on_card(cuda_device, layout):
    """The score forward and backward over the GAT adjacency of a power-law
    graph (where misaligned features also take the scalar path) and over the
    hand-made CSRs: a 60,000-edge hub, rows on tile boundaries, empty rows,
    no edges; sources drawn from 1,000 nodes, so the transpose's rows are
    long too."""
    rng = np.random.default_rng(4)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    if layout == "power-law":
        adj = _attention_graph(cuda_device)
        csr = (adj.row_ptr, adj.src, adj.dst, adj.t_row_ptr, adj.t_perm, adj.t_col)
        n_dst = n_src = adj.num_dst_nodes
    else:
        deg = np.asarray(_SKEWED_DEGREES[layout])
        n_dst, n_src = deg.size, 1000
        dst = np.repeat(np.arange(n_dst), deg).astype(np.int32)
        src = rng.integers(0, n_src, dst.size).astype(np.int32)
        row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        csr = tuple(as_dev(a) for a in (row_ptr, src, dst, *_transpose(dst, src, n_src)))
    for H, F in _GATV2_HEADS:
        h_src = as_dev(rng.normal(size=(n_src, H, F)).astype(np.float32))
        h_dst = as_dev(rng.normal(size=(n_dst, H, F)).astype(np.float32))
        att = as_dev(rng.normal(size=(H, F)).astype(np.float32))
        _check_gatv2(csr, h_src, h_dst, att)
        if layout == "power-law" and F % 4 == 0:
            hs = _misaligned(n_src, H * F, torch.float32, cuda_device).view(n_src, H, F)
            hd = _misaligned(n_dst, H * F, torch.float32, cuda_device).view(n_dst, H, F)
            _check_gatv2(csr, hs, hd, att)


@pytest.mark.gpu
def test_gatv2_score_rejects_bad_arguments(cuda_device):
    dst = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    src = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    h = torch.randn(2, 4, 8, device=cuda_device)
    att = torch.randn(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        gatv2_score(h.bfloat16(), h, att, src, dst)
    with pytest.raises(ValueError, match="contiguous float32"):
        gatv2_score(h.transpose(0, 1).contiguous().transpose(0, 1), h, att, src, dst)
    with pytest.raises(ValueError, match="h_dst is on cpu"):
        gatv2_score(h, h.cpu(), att, src, dst)
    with pytest.raises(ValueError, match="one \\(H, F\\)"):
        gatv2_score(h, h[:, :2], att, src, dst)
    with pytest.raises(ValueError, match="src must be a contiguous 1-D int32"):
        gatv2_score(h, h, att, src.long(), dst)
    with pytest.raises(ValueError, match="one length"):
        gatv2_score(h, h, att, src[:1], dst)
    with pytest.raises(ValueError, match="ds must be"):
        gatv2_score_bwd(torch.ones(3, 4, device=cuda_device), h, h, att, dst, src, dst, src, dst)


# Heads of the softmax on the card: the benchmark's two layers (8 and 1), the
# scalar path (3), and rows wider than one pass of a warp (40 scalar, 160
# vector)
_SOFTMAX_HEADS = (8, 1, 3, 40, 160)


def _check_edge_softmax(row_ptr, dst, e):
    """The softmax's kernels on the card, each twice (bitwise equal: no
    atomics; the forward without a sync), against their plain versions,
    one launch of each a call. ex
    and de repeat the plain arithmetic, the same max included (rtol 1e-6,
    an exp apart). den sums a row in another order, and a row cut by a warp
    boundary from segments taken with their own max: it is held to the
    float64 sum of the plain version's ex (rtol 1e-5; the plain version's
    own float32 index_add_ strays 1.5e-5 over the 60,000-edge hub)."""
    before = (edge_softmax.launches, edge_softmax_bwd.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex, den = edge_softmax(e, row_ptr)
        again = edge_softmax(e, row_ptr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(ex, again[0]) and torch.equal(den, again[1])
    want_ex, _ = edge_softmax_plain(e, row_ptr)
    torch.testing.assert_close(ex, want_ex, rtol=1e-6, atol=1e-30)
    want_den = torch.zeros(den.shape, dtype=torch.float64, device=den.device)
    want_den = want_den.index_add_(0, dst.long(), want_ex.double()).clamp_min(1e-16)
    torch.testing.assert_close(den.double(), want_den, rtol=1e-5, atol=1e-30)
    g_ex, g_den = torch.randn_like(ex), torch.randn_like(den)  # signed, as the step's are
    de = edge_softmax_bwd(ex, g_ex, g_den, dst)
    assert torch.equal(de, edge_softmax_bwd(ex, g_ex, g_den, dst))
    torch.testing.assert_close(de, edge_softmax_bwd_plain(ex, g_ex, g_den, dst), rtol=1e-6, atol=1e-30)
    torch.cuda.synchronize()
    edges = int(dst.numel() > 0)
    assert (edge_softmax.launches - before[0], edge_softmax_bwd.launches - before[1]) == (2, 2 * edges)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["power-law"] + list(_SKEWED_DEGREES))
def test_edge_softmax_matches_plain_version_on_card(cuda_device, layout):
    """The softmax by destination forward and backward over the GAT
    adjacency of a power-law graph (where scores off the vector-load
    boundary also take the scalar path) and over the hand-made CSRs: empty
    rows, a 60,000-edge hub that spans many CTAs' tiles, rows that end on a
    tile boundary, no edges. The scores span +-30."""
    rng = np.random.default_rng(5)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    if layout == "power-law":
        adj = _attention_graph(cuda_device)
        row_ptr, dst = adj.row_ptr, adj.dst
    else:
        deg = np.asarray(_SKEWED_DEGREES[layout])
        row_ptr = as_dev(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
        dst = as_dev(np.repeat(np.arange(deg.size), deg).astype(np.int32))
    for H in _SOFTMAX_HEADS:
        e = as_dev(rng.uniform(-30, 30, size=(dst.numel(), H)).astype(np.float32))
        _check_edge_softmax(row_ptr, dst, e)
        if layout == "power-law" and H % 4 == 0:
            _check_edge_softmax(row_ptr, dst, _misaligned(dst.numel(), H, torch.float32, cuda_device).mul_(30))


@pytest.mark.gpu
def test_edge_softmax_rejects_bad_arguments(cuda_device):
    row_ptr = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda_device)
    dst = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    e = torch.randn(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        edge_softmax(e.bfloat16(), row_ptr)
    with pytest.raises(ValueError, match="contiguous float32"):
        edge_softmax(e.t().contiguous().t(), row_ptr)
    with pytest.raises(ValueError, match="row_ptr is on cpu"):
        edge_softmax(e, row_ptr.cpu())
    with pytest.raises(ValueError, match="row_ptr must be a contiguous 1-D int32"):
        edge_softmax(e, row_ptr.long())
    adj = _attention_graph(cuda_device, n=50)
    with pytest.raises(ValueError, match="edge scores"):
        edge_softmax_parts(torch.randn(adj.num_edges + 1, 8, device=cuda_device), adj)
    with pytest.raises(ValueError, match="g_den is on cpu"):
        edge_softmax_bwd(e, e, e.cpu(), dst)
    with pytest.raises(ValueError, match="one entry an edge"):
        edge_softmax_bwd(e, e, e, dst[:1])


@pytest.mark.gpu
def test_gatv2_on_card_matches_cpu(cuda_device):
    """A training step of the 2-layer GATv2 (4 heads x 8, then 1 head over 4
    classes) on the card against the same model on the CPU (plain
    versions): output, input gradient and every parameter's gradient, and
    the launches: the score's forward and backward once a layer, K3, the
    SDDMM and the softmax as in GAT, K1 and K2 not at all (the score gathers
    nothing whose VJP would run them)."""
    from gnn_tpu_torch.models import GATv2

    adj = _attention_graph("cpu", n=2000)
    x = torch.randn(adj.num_dst_nodes, 16)
    model_cpu = GATv2(16, 8, 4, heads=4, dropout=0.0, generator=torch.Generator().manual_seed(0))
    model_gpu = GATv2(16, 8, 4, heads=4, dropout=0.0).to(cuda_device)
    model_gpu.load_state_dict(model_cpu.state_dict())
    counters = (csr_spmm, segment_sum_csr, csr_spmm_heads, sddmm_heads, gatv2_score, gatv2_score_bwd, edge_softmax,
                edge_softmax_bwd)
    outs = []
    for model, a, xx in ((model_cpu, adj, x), (model_gpu, adj.to(cuda_device), x.to(cuda_device))):
        before = tuple(c.launches for c in counters)
        xx = xx.clone().requires_grad_()
        out = model(xx, a)
        (out ** 2).sum().backward()
        outs.append((out.detach().cpu(), xx.grad.cpu(), [p.grad.cpu() for p in model.parameters()]))
        torch.cuda.synchronize()
        launches = tuple(c.launches - b for c, b in zip(counters, before))
    assert launches == (0, 0, 4, 2, 2, 2, 2, 2)
    (o_c, dx_c, g_c), (o_g, dx_g, g_g) = outs
    torch.testing.assert_close(o_g, o_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx_g, dx_c, rtol=1e-4, atol=1e-4)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _clustered_adjacency(block_dtype=None, n=3000):
    """A clustered power-law graph with GCN weights through reorder='cluster'
    (256-row windows), on the CPU."""
    ei, _ = tg.to_undirected(tg.clustered_power_law(n, 30000, avg_community=100, seed=0), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    return tg.build_adjacency(ei, w, num_nodes=n, reorder="cluster", block_dtype=block_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("block_dtype", [None, torch.bfloat16], ids=["f32-blocks", "bf16-blocks"])
def test_blocked_matvec_matches_plain_version_on_card(cuda_device, block_dtype):
    """``spmm`` over a cluster adjacency on the card (``block_dtype``
    builds nothing) runs K1, one launch forward and one for dx, each
    against K1's plain version over the relabelled CSR and its transpose,
    rtol=atol=1e-4 as for K1 in float32."""
    adj = _clustered_adjacency(block_dtype).to(cuda_device)
    assert adj.layout == "blocked" and adj.perm is not None
    for F in (64, 40):
        x = torch.randn(adj.num_dst_nodes, F, device=cuda_device, requires_grad=True)
        g = torch.randn(adj.num_dst_nodes, F, device=cuda_device)
        k1 = csr_spmm.launches
        out = tops.spmm(adj, x)
        out.backward(g)
        torch.cuda.synchronize()
        assert csr_spmm.launches - k1 == 2
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, csr_spmm_plain(adj.row_ptr, adj.src, adj.weight, x.detach()),
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(x.grad, csr_spmm_plain(adj.t_row_ptr, adj.t_col, adj.t_weight, g),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_blocked_spmm_backward_on_card_matches_cpu(cuda_device):
    """``spmm`` over a cluster adjacency, forward and dx, on the card
    against the CPU path; the 'segment' backend on the card gives the same
    bits as 'auto', both K1."""
    adj = _clustered_adjacency()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(adj.num_dst_nodes, 32)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(adj.num_dst_nodes, 32)).astype(np.float32))
    outs = []
    for a, backend in ((adj, "auto"), (adj.to(cuda_device), "auto"), (adj.to(cuda_device), "segment")):
        xx = x.detach().to(a.device).requires_grad_()
        out = tops.spmm(a, xx, backend=backend)
        (out ** 2 * ct.to(a.device)).sum().backward()
        outs.append((out.detach().cpu(), xx.grad.cpu()))
    for out, grad in outs[1:]:
        torch.testing.assert_close(out, outs[0][0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(grad, outs[0][1], rtol=1e-4, atol=1e-4)
    assert torch.equal(outs[1][0], outs[2][0]) and torch.equal(outs[1][1], outs[2][1])


def _conv_on_card_matches_cpu(make, cuda_device, n=600):
    """Output and gradients (parameters and input) of one conv on the card
    against the CPU, rtol=atol=1e-4; returns K1's launches on the card."""
    torch.manual_seed(0)
    ei, _ = tg.to_undirected(tg.power_law(n, 6000, seed=1), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    adj_cpu = tg.build_adjacency(ei, w, num_nodes=n)
    conv_cpu = make(torch.Generator().manual_seed(0))
    conv_gpu = make(None).to(cuda_device)
    conv_gpu.load_state_dict(conv_cpu.state_dict())
    x = torch.randn(n, 24)
    ct = torch.randn(n, 16)
    xs = []
    before = csr_spmm.launches
    for conv, adj, dev in ((conv_cpu, adj_cpu, "cpu"), (conv_gpu, adj_cpu.to(cuda_device), cuda_device)):
        xd = x.clone().to(dev).requires_grad_()  # a leaf on either device
        xs.append(xd)
        (conv(xd, adj) * ct.to(dev)).sum().backward()
    launches = csr_spmm.launches - before
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(xs[1].grad.cpu(), xs[0].grad, **tol)
    for (name, p_gpu), p_cpu in zip(conv_gpu.named_parameters(), conv_cpu.parameters()):
        if p_cpu.grad is not None:
            torch.testing.assert_close(p_gpu.grad.cpu(), p_cpu.grad, msg=name, **tol)
    out_gpu = conv_gpu(x.to(cuda_device), adj_cpu.to(cuda_device))
    torch.testing.assert_close(out_gpu.cpu(), conv_cpu(x, adj_cpu), **tol)
    return launches


@pytest.mark.gpu
@pytest.mark.parametrize("aggr,launches", [("mean", 2), ("sum", 2), ("max", 0)])
def test_sageconv_on_card_matches_cpu(cuda_device, aggr, launches):
    """sum and mean aggregate through K1 (forward and dx; the CPU pass
    launches nothing); max has no kernel."""
    from gnn_tpu_torch.mp import SAGEConv

    got = _conv_on_card_matches_cpu(lambda gen: SAGEConv(24, 16, aggr=aggr, generator=gen), cuda_device)
    assert got == launches


@pytest.mark.gpu
@pytest.mark.parametrize("train_eps", [False, True])
def test_ginconv_on_card_matches_cpu(cuda_device, train_eps):
    from gnn_tpu_torch.mp import GINConv

    make = lambda gen: GINConv(24, [16, 16], eps=0.2, train_eps=train_eps, generator=gen)
    assert _conv_on_card_matches_cpu(make, cuda_device) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_without_weights_at_f128_on_card(cuda_device, dtype):
    """GIN's shape: a null weight pointer at F=128, forward and transpose,
    against the plain version and bitwise against a second call."""
    n = 3000
    ei, _ = tg.to_undirected(tg.power_law(n, 40000, seed=0), num_nodes=n)
    adj = tg.build_adjacency(ei, None, num_nodes=n).to(cuda_device)
    assert adj.weight is None and adj.t_weight is None
    x = torch.randn(n, 128, device=cuda_device).to(dtype)
    before = csr_spmm.launches
    _check_deterministic(csr_spmm, csr_spmm_plain, (adj.row_ptr, adj.src, None, x), dtype)
    _check_deterministic(csr_spmm, csr_spmm_plain, (adj.t_row_ptr, adj.t_col, None, x), dtype)
    assert csr_spmm.launches - before == 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("F", [8, 40, 128, 256])
@pytest.mark.parametrize("n_dst,fanout", [(1, 1), (1, 15), (1024, 1), (1024, 5), (1024, 15)])
def test_kernels_on_sampled_hop_csrs_on_card(cuda_device, dtype, F, n_dst, fanout):
    """K1 (w null), K2 and K3 over a neighbour-sampled hop's bipartite CSR
    (n_dst rows of exactly ``fanout`` edges over n_dst * (1 + fanout)
    sources, ``col`` contiguous from n_dst) and over its transpose (n_dst
    leading rows without an edge, then one edge a row): against the plain
    versions, bitwise on a repeat, output shapes from ``row_ptr``."""
    from gnn_tpu_torch.graphs.sampling import _hop_adjacency

    adj = _hop_adjacency(n_dst, fanout).to(cuda_device)
    n_src, e = adj.num_src_nodes, adj.num_edges
    make = lambda *shape: torch.randn(*shape, device=cuda_device).to(dtype)
    x, g, msg = make(n_src, F), make(n_dst, F), make(e, F)
    _check_deterministic(csr_spmm, csr_spmm_plain, (adj.row_ptr, adj.src, None, x), dtype)
    _check_deterministic(csr_spmm, csr_spmm_plain, (adj.t_row_ptr, adj.t_col, None, g), dtype)
    _check_deterministic(csr_spmm, csr_spmm_plain, (adj.t_row_ptr, adj.t_perm, None, msg), dtype)
    _check_deterministic(segment_sum_csr, segment_sum_csr_plain, (adj.row_ptr, msg), dtype)
    assert tuple(csr_spmm(adj.row_ptr, adj.src, None, x).shape) == (n_dst, F)
    dx = csr_spmm(adj.t_row_ptr, adj.t_col, None, g)
    assert tuple(dx.shape) == (n_src, F) and not dx[:n_dst].any()  # the prefix sends nothing
    H = 8 if F % 8 == 0 else 1
    w = torch.rand(e, H, device=cuda_device)
    xh, gh = x.view(n_src, H, F // H), g.view(n_dst, H, F // H)
    _check_deterministic(csr_spmm_heads, csr_spmm_heads_plain, (adj.row_ptr, adj.src, w, xh), dtype)
    _check_deterministic(
        csr_spmm_heads, csr_spmm_heads_plain, (adj.t_row_ptr, adj.t_col, w, gh, adj.t_perm), dtype
    )


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sage", "sage-max", "gat", "gin"])
def test_forward_sampled_on_card_matches_cpu(cuda_device, name):
    """One node list through ``forward_sampled`` on the card and on the CPU:
    logits and parameter gradients (float32, rtol=atol=1e-4), with the
    kernels launched as the hops ask: SAGE mean and GIN K1 2 forward + 1 dx
    (the first hop's input is gathered data); GAT, per hop, K3 forward and
    dh (the first hop's too: its input is ``lin``'s output), the SDDMM, the
    softmax forward and backward and the score's C entries forward and
    backward (its backward runs K2 and K1 inside, not through their
    wrappers)."""
    from gnn_tpu_torch.graphs import NeighborSampler
    from gnn_tpu_torch.models import GAT, GIN, GraphSAGE

    data = tg.stochastic_block_model(num_nodes=300, num_classes=4, feature_dim=12, seed=1)
    make = {
        "sage": lambda gen: GraphSAGE(12, 32, 4, dropout=0.0, generator=gen),
        "sage-max": lambda gen: GraphSAGE(12, 32, 4, aggr="max", dropout=0.0, generator=gen),
        "gat": lambda gen: GAT(12, 8, 4, heads=4, dropout=0.0, generator=gen),
        "gin": lambda gen: GIN(12, 32, 4, num_layers=2, generator=gen),
    }[name]
    want = {"sage": (3, 0, 0, 0, 0, 0, 0, 0), "sage-max": (0, 0, 0, 0, 0, 0, 0, 0), "gat": (0, 0, 4, 2, 2, 2, 2, 2),
            "gin": (3, 0, 0, 0, 0, 0, 0, 0)}[name]
    sampler = NeighborSampler(data, [5, 3])
    nodes, adjs = sampler.sample(torch.Generator().manual_seed(0), torch.arange(64))
    cpu = make(torch.Generator().manual_seed(0))
    gpu = make(None).to(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    on_card = sampler.to(cuda_device)
    counters = (csr_spmm, segment_sum_csr, csr_spmm_heads, sddmm_heads, edge_softmax, edge_softmax_bwd, gat_score,
                gat_score_bwd)
    before = tuple(c.launches for c in counters)
    out_gpu = gpu.forward_sampled(data.x[nodes].to(cuda_device), on_card.adjacencies(64))
    out_gpu.square().sum().backward()
    after = tuple(c.launches for c in counters)
    assert tuple(a - b for a, b in zip(after, before)) == want
    out_cpu = cpu.forward_sampled(data.x[nodes], adjs)
    out_cpu.square().sum().backward()
    torch.testing.assert_close(out_gpu.cpu(), out_cpu, rtol=1e-4, atol=1e-4)
    for (pname, p_gpu), p_cpu in zip(gpu.named_parameters(), cpu.parameters()):
        if p_cpu.requires_grad:
            torch.testing.assert_close(p_gpu.grad.cpu(), p_cpu.grad, rtol=1e-4, atol=1e-4, msg=pname)


@pytest.mark.gpu
def test_sampler_on_card_draws_in_neighbours_without_leaving_it(cuda_device):
    from gnn_tpu_torch.graphs import NeighborSampler

    data = tg.stochastic_block_model(num_nodes=300, num_classes=4, feature_dim=4, seed=1)
    sampler = NeighborSampler(data, [6, 4]).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    seeds = torch.arange(50, device=cuda_device)
    sampler.adjacencies(50)  # built on the host and moved once, before the steps
    torch.cuda.set_sync_debug_mode("error")  # a host round trip inside sample() raises
    try:
        nodes, adjs = sampler.sample(gen, seeds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert nodes.device.type == "cuda" and all(a.row_ptr.device.type == "cuda" for a in adjs)
    assert nodes.shape[0] == 50 * 7 * 5 and torch.equal(nodes[:50], seeds)
    ei = data.edge_index.numpy()
    in_nbrs = [set(ei[0][ei[1] == d].tolist()) or {d} for d in range(300)]
    nodes = nodes.cpu()
    for adj in adjs:
        src, dst = nodes[adj.src.cpu().long()].tolist(), nodes[adj.dst.cpu().long()].tolist()
        assert all(s in in_nbrs[d] for s, d in zip(src, dst))


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_coo_card_matches_cpu(cuda_device, weighted):
    """The plain gather + index_add on both devices: no kernel launch."""
    n, e = 500, 4000
    rng = np.random.default_rng(0)
    dst = np.sort(rng.integers(0, n - 20, e))  # the last 20 rows stay empty
    src = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) if weighted else None
    x = rng.normal(size=(n, 24)).astype(np.float32)
    outs = []
    for device in ("cpu", cuda_device):
        tx = torch.from_numpy(x).to(device).requires_grad_()
        tw = None if w is None else torch.from_numpy(w).to(device).requires_grad_()
        before = csr_spmm.launches
        out = tops.spmm_coo(torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device), tx, n, tw,
                            indices_are_sorted=True)
        assert csr_spmm.launches == before
        out.square().sum().backward()
        outs.append((out.detach().cpu(), tx.grad.cpu(), None if tw is None else tw.grad.cpu()))
    for got, want in zip(outs[1], outs[0]):
        if want is not None:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _relabelled_power_law(n=3000, e=40000, reorder=True):
    ei, _ = tg.to_undirected(tg.power_law(n, e, seed=5), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    return tg.build_adjacency(ei, w, num_nodes=n, reorder=reorder)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 40, 128])
def test_k1_k2_k3_on_relabelled_csr_on_card(cuda_device, dtype, F):
    """The degree-bucket relabelled CSR through K1 (weighted, w null, over
    t_perm), K2 and K3: against the plain versions and bitwise on a
    repeat; spmm over 'sorted' equals 'segment' bit for bit."""
    adj = _relabelled_power_law().to(cuda_device)
    assert adj.perm is not None and adj.layout == "sorted"
    n, e = adj.num_dst_nodes, adj.num_edges
    make = lambda *shape: torch.randn(*shape, device=cuda_device).to(dtype)
    x, msg = make(n, F), make(e, F)
    for args in ((adj.row_ptr, adj.src, adj.weight, x), (adj.row_ptr, adj.src, None, x),
                 (adj.t_row_ptr, adj.t_col, adj.t_weight, x), (adj.t_row_ptr, adj.t_perm, None, msg)):
        _check_deterministic(csr_spmm, csr_spmm_plain, args, dtype)
    _check_deterministic(segment_sum_csr, segment_sum_csr_plain, (adj.row_ptr, msg), dtype)
    H = 8 if F % 8 == 0 else 1
    w = torch.rand(e, H, device=cuda_device)
    _check_deterministic(csr_spmm_heads, csr_spmm_heads_plain, (adj.row_ptr, adj.src, w, x.view(n, H, F // H)), dtype)
    assert torch.equal(tops.spmm(adj, x, backend="sorted"), tops.spmm(adj, x, backend="segment"))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["edge_agg", "t_edge_agg"])
@pytest.mark.parametrize("F", [1, 8])
def test_edge_aggregate_runs_k2_or_k1_on_card(cuda_device, which, F):
    """edge_aggregate over the identity positions launches K2 once, over
    t_perm K1 once; its gradient is a gather; edge_aggregate_max equals the
    CPU's bit for bit (-inf on empty rows)."""
    from gnn_tpu_torch.ops.edge_agg import edge_aggregate, edge_aggregate_max

    cpu = _relabelled_power_law()
    adj = cpu.to(cuda_device)
    lay, lay_cpu = getattr(adj, which), getattr(cpu, which)
    msg_cpu = torch.randn(adj.num_edges, F)
    msg = msg_cpu.to(cuda_device).requires_grad_()
    k1, k2 = csr_spmm.launches, segment_sum_csr.launches
    out = edge_aggregate(msg, lay)
    torch.cuda.synchronize()
    assert (csr_spmm.launches - k1, segment_sum_csr.launches - k2) == ((0, 1) if which == "edge_agg" else (1, 0))
    torch.testing.assert_close(out.cpu(), edge_aggregate(msg_cpu, lay_cpu), rtol=1e-4, atol=1e-4)
    assert torch.equal(out, edge_aggregate(msg.detach(), lay))
    g = torch.randn_like(out)
    out.backward(g)
    assert torch.equal(msg.grad, g.index_select(0, lay.edge_node.long()))
    assert torch.equal(edge_aggregate_max(msg, lay).cpu(), edge_aggregate_max(msg_cpu, lay_cpu))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unweighted", "weighted", "norm"])
@pytest.mark.parametrize("chunk_edges", [1000, 4096, 1 << 20])
def test_streaming_spmm_equals_resident_k1_on_card(cuda_device, mode, chunk_edges):
    """Every chunk count from one to many (1,000-edge chunks: 80 chunks,
    each staging buffer refilled 40 times): the streamed product equals the
    resident K1 over the same CSR within float32 order error, repeats bit
    for bit, launches K1 once a chunk, and its gradient streams the
    transpose."""
    from gnn_tpu_torch.graphs.streaming import EdgeStream, streaming_spmm, streaming_spmm_grad

    n = 3000
    ei, _ = tg.to_undirected(tg.power_law(n, 40000, seed=6), num_nodes=n)
    rng = np.random.default_rng(0)
    w = rng.random(ei.shape[1]).astype(np.float32) if mode == "weighted" else None
    norm_np = rng.random(n).astype(np.float32)
    stream = EdgeStream(ei, w, num_nodes=n, chunk_edges=chunk_edges)
    adj = tg.build_adjacency(ei, w, num_nodes=n)
    norm = None
    if mode == "norm":
        norm = torch.from_numpy(norm_np).to(cuda_device)
        adj = adj.with_weight(torch.from_numpy(norm_np[adj.src.numpy()] * norm_np[adj.dst.numpy()]))
    adj = adj.to(cuda_device)
    x = torch.randn(n, 64, device=cuda_device)
    before = csr_spmm.launches
    stats = {}
    got = streaming_spmm(stream, x, norm=norm, stats=stats)
    torch.cuda.synchronize()
    assert csr_spmm.launches - before == stream.num_chunks == stats["chunks"]
    assert len(stats["copy_ms"]) == len(stats["k1_ms"]) == stream.num_chunks
    resident = csr_spmm(adj.row_ptr, adj.src, adj.weight, x)
    torch.testing.assert_close(got, resident, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, streaming_spmm(stream, x, norm=norm))
    xr = x.clone().requires_grad_()
    g = torch.randn(n, 64, device=cuda_device)
    streaming_spmm_grad(stream, stream.transpose(), xr, norm=norm).backward(g)
    torch.testing.assert_close(xr.grad, csr_spmm(adj.t_row_ptr, adj.t_col, adj.t_weight, g), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_device_put_slabbed_and_entry_on_card(cuda_device):
    """A slabbed copy through the two pinned buffers lands whole; the
    flagship forward on the card equals the CPU's."""
    from gnn_tpu_torch.entry import entry
    from gnn_tpu_torch.graphs.streaming import device_put_slabbed

    arr = np.random.default_rng(1).normal(size=(10_001, 33)).astype(np.float32)
    got = device_put_slabbed(arr, slab_bytes=33 * 4 * 700)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), torch.from_numpy(arr))
    fn, args = entry()
    fn_cpu, args_cpu = entry(device="cpu")
    args[0].load_state_dict(args_cpu[0].state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fn(*args).cpu(), fn_cpu(*args_cpu), rtol=1e-4, atol=1e-5)


def _dist_pair(device, halo, P, blocked=0, weighted=True):
    """The same partition on the card and on the CPU (every part in one
    process), with a 3000-node power-law graph."""
    from gnn_tpu_torch.parallel import make_mesh, partition_graph

    n = 3000
    ei, _ = tg.to_undirected(tg.power_law(n, 30000, seed=1), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    out = []
    for dev in (device, torch.device("cpu")):
        mesh = make_mesh(axes=("data",), devices=[dev] * P)
        out.append(partition_graph(ei, w if weighted else None, num_nodes=n, mesh=mesh, halo=halo,
                                   local_blocked=blocked))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("halo,P,blocked", [("allgather", 4, 0), ("alltoall", 4, 0), ("alltoall", 2, 0),
                                            ("overlap", 4, 0), ("overlap", 4, 64)])
@pytest.mark.parametrize("F", [8, 64])
def test_dist_ops_launch_k1_k2_on_card(cuda_device, halo, P, blocked, F):
    """Every per-part product and reduction of parallel/halo.py is one K1 or
    K2 launch for all parts, equal to the CPU partition's plain versions and
    bitwise equal on a repeat: spmm_dist (K1 forward, K1 dx; overlap two of
    each), gather_src_dist's VJP (K1 over the incidence CSR, and over the
    send CSR in the targeted modes), edge_reduce_by_dst and gather_dst_dist's
    VJP (K2)."""
    from gnn_tpu_torch.parallel import edge_reduce_by_dst, gather_dst_dist, gather_src_dist, spmm_dist

    card, cpu = _dist_pair(cuda_device, halo, P, blocked)
    tol = _tolerance(torch.float32)
    x = torch.randn(P * card.n_max, F)
    g = torch.randn(P * card.n_max, F)
    ge = torch.randn(P * card.e_max, F)
    k1 = 2 if halo == "overlap" else 1
    for op, kernel, want_launches in (
        (lambda d, v: spmm_dist(d, v), "k1", k1),
        (lambda d, v: gather_src_dist(d, v), "k1", 1 if halo == "allgather" else 2),
        (lambda d, v: gather_dst_dist(d, v), "k2", 1),
    ):
        outs = []
        for d, dev in ((card, cuda_device), (cpu, torch.device("cpu"))):
            xv = x.to(dev, copy=True).requires_grad_()  # a leaf on either device
            y = op(d, xv)
            before = (csr_spmm.launches, segment_sum_csr.launches)
            y.backward(ge.to(dev) if y.shape[0] == P * card.e_max else g.to(dev))
            torch.cuda.synchronize()
            launched = (csr_spmm.launches - before[0], segment_sum_csr.launches - before[1])
            outs.append((y.detach().cpu(), xv.grad.cpu(), launched))
        (y1, g1, launched), (y0, g0, _) = outs
        torch.testing.assert_close(y1, y0, **tol)
        torch.testing.assert_close(g1, g0, **tol)
        assert launched == ((want_launches, 0) if kernel == "k1" else (0, want_launches)), launched
    s = edge_reduce_by_dst(card, ge.to(cuda_device))
    torch.testing.assert_close(s.cpu(), edge_reduce_by_dst(cpu, ge), **tol)
    assert torch.equal(s, edge_reduce_by_dst(card, ge.to(cuda_device)))
    xc = x.to(cuda_device)
    assert torch.equal(spmm_dist(card, xc), spmm_dist(card, xc))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gcn", "gat", "sage", "gin"])
def test_dist_models_on_card_match_cpu(cuda_device, name):
    """A model on the card's partition against the same model on the CPU's:
    logits and parameter gradients."""
    from gnn_tpu_torch.models import GAT, GCN, GIN, GraphSAGE

    card, cpu = _dist_pair(cuda_device, "alltoall", 4)
    make = {"gcn": lambda g: GCN(16, 32, 4, dropout=0.0, generator=g),
            "gat": lambda g: GAT(16, 8, 4, heads=4, dropout=0.0, generator=g),
            "sage": lambda g: GraphSAGE(16, 32, 4, dropout=0.0, generator=g),
            "gin": lambda g: GIN(16, 32, 4, generator=g)}[name]
    x = torch.randn(4 * card.n_max, 16)
    grads = []
    for d, dev in ((card, cuda_device), (cpu, torch.device("cpu"))):
        model = make(torch.Generator().manual_seed(0)).to(dev)
        out = model(x.to(dev), d)
        torch.sin(out).sum().backward()
        grads.append((out.detach().cpu(), [p.grad.cpu() for p in model.parameters() if p.grad is not None]))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
def test_dist_edge_stream_on_card_matches_cpu_one_k1_a_chunk(cuda_device, weighted):
    """DistEdgeStream.spmm_host over 4 parts of the card: the CPU's result,
    bitwise on a repeat, one K1 launch a chunk for all the parts."""
    from gnn_tpu_torch.graphs.streaming import DistEdgeStream
    from gnn_tpu_torch.parallel import make_mesh

    n = 3000
    ei, _ = tg.to_undirected(tg.power_law(n, 40000, seed=0), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    stream = DistEdgeStream(ei, w if weighted else None, num_nodes=n, num_parts=4, chunk_edges=4096)
    x = np.random.default_rng(0).standard_normal((n, 40), dtype=np.float32)
    card_mesh = make_mesh((4,), ("data",), devices=[cuda_device] * 4)
    before = csr_spmm.launches
    got = stream.spmm_host(x, card_mesh)
    torch.cuda.synchronize()
    assert csr_spmm.launches - before == stream.num_chunks > 1
    want = stream.spmm_host(x, make_mesh((4,), ("data",), devices=["cpu"] * 4))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, stream.spmm_host(x, card_mesh))


@pytest.mark.gpu
def test_tensor_parallel_gcn_on_card_matches_cpu(cuda_device):
    """A GCN sharded over the model axis of a (2, 2) mesh of the card: loss
    and gradients equal the CPU's (4 K1 launches: 2 layers forward and dx)."""
    from gnn_tpu_torch.models import GCN
    from gnn_tpu_torch.nn import cross_entropy
    from gnn_tpu_torch.parallel import make_mesh, partition_graph, shard_model, shard_node_array

    n = 2000
    ei, _ = tg.to_undirected(tg.power_law(n, 20000, seed=1), num_nodes=n)
    ei, w = tg.gcn_norm(ei, num_nodes=n)
    x = np.random.default_rng(1).standard_normal((n, 16), dtype=np.float32)
    y = torch.from_numpy(np.random.default_rng(2).integers(0, 4, n))
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
        dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="alltoall")
        model = shard_model(GCN(16, 32, 4, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(dev), mesh)
        before = csr_spmm.launches
        loss = cross_entropy(model(shard_node_array(dist, x, mesh), dist), dist.shard_nodes(y.to(dev)),
                             dist.shard_nodes(torch.ones(n, dtype=torch.bool, device=dev), fill=False))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert csr_spmm.launches - before == 4
        results.append((loss.item(), [p.grad.cpu() for p in model.parameters()]))
    assert abs(results[0][0] - results[1][0]) < 1e-5
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5)


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: one process a card")
    return [torch.device("cuda", i) for i in range(4)]


def _spawn_on_four_cards(fn, args: tuple) -> None:
    """Four processes of ``fn(rank, *args)`` (tests/torch_four_process_worker.py),
    one a card, 120 s at most."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, args=args, nprocs=4, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the four-card run took more than 120 s")


@pytest.mark.gpu
def test_spmm_dist_on_four_cards_matches_one_card(four_cards, tmp_path):
    """NCCL between four cards, one part a card: ``spmm_dist`` forward and
    dx in each halo mode and the ``gather_src_dist`` VJP equal each card's
    rows of single-device K1."""
    import torch_four_process_worker as worker

    _spawn_on_four_cards(worker.cards_spmm, (f"file://{tmp_path / 'store'}",))


@pytest.mark.gpu
def test_fit_on_four_cards_matches_four_parts_on_one_card(four_cards, tmp_path):
    """``fit`` of the GCN (Adam) and EncoderGCN (SGD) with ``dist.num_parts=4``
    on four cards against the same ``fit`` with the 4 parts in one process on
    one card: loss curves at rtol 1e-5, the same K1 / K2 launches (each
    launch serves every local part), parameters equal on the cards."""
    import torch_four_process_worker as worker
    from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr
    from gnn_tpu_torch.train import Config, fit

    cases = {}
    for name, optim in (("gcn", "adam"), ("encoder_gcn", "sgd")):
        case = dict(cfg={"model": {"name": name, "hidden": 16, "dropout": 0.0}, "optim": {"name": optim, "lr": 0.01},
                         "train": {"epochs": 6, "eval_every": 2}, "dist": {"num_parts": 4}}, nodes=400, seed=5)
        data = worker.data_of(case)
        cfg = Config.from_dict(case["cfg"])
        before = (csr_spmm.launches, segment_sum_csr.launches)
        _, _, history = fit(cfg, data, model=worker.model_of(cfg, data, None), device=four_cards[0], verbose=False)
        torch.cuda.synchronize()
        case["launches"] = [csr_spmm.launches - before[0], segment_sum_csr.launches - before[1]]
        case["losses"] = [h["loss"] for h in history]
        cases[name] = case
    _spawn_on_four_cards(worker.cards_fit, (f"file://{tmp_path / 'store'}", cases))
