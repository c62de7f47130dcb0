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
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr, segment_sum_csr_plain
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain
from gnn_tpu_torch.ops.cuda.spmm_heads import csr_spmm_heads, csr_spmm_heads_plain


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


@pytest.mark.gpu
def test_gat_on_card_matches_cpu(cuda_device):
    """GATConv forward and gradients on the card (K1, K2, K3) against the
    same layer on the CPU (plain versions), and the launches of each."""
    from gnn_tpu_torch.mp import GATConv

    adj = _attention_graph("cpu", n=2000)
    x = torch.randn(adj.num_dst_nodes, 16)
    conv_cpu = GATConv(16, 8, heads=4, generator=torch.Generator().manual_seed(0))
    conv_gpu = GATConv(16, 8, heads=4).to(cuda_device)
    conv_gpu.load_state_dict(conv_cpu.state_dict())
    before = (csr_spmm.launches, segment_sum_csr.launches, csr_spmm_heads.launches)
    outs = []
    for conv, a, xx in ((conv_cpu, adj, x), (conv_gpu, adj.to(cuda_device), x.to(cuda_device))):
        xx = xx.clone().requires_grad_()
        out = conv(xx, a)
        (out ** 2).sum().backward()
        outs.append((out.detach().cpu(), xx.grad.cpu(), [p.grad.cpu() for p in conv.parameters()]))
    torch.cuda.synchronize()
    after = (csr_spmm.launches, segment_sum_csr.launches, csr_spmm_heads.launches)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 2, 2)
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
    """blocked_matvec (block product, then K1 over the remainder CSR)
    forward and transpose against its plain version on the card: the same
    block product, the remainder through K1's plain version, so rtol=atol=1e-4
    as for K1 in float32. One K1 launch per product."""
    from gnn_tpu_torch.graphs.blocked import blocked_matvec, blocked_matvec_plain

    adj = _clustered_adjacency(block_dtype).to(cuda_device)
    assert adj.blocked.num_rem_edges > 0 and adj.blocked.num_dense_edges > 0
    k1, bm = csr_spmm.launches, blocked_matvec.launches
    for F in (64, 40):
        for lay in (adj.blocked, adj.t_blocked):
            x = torch.randn(adj.num_dst_nodes, F, device=cuda_device)
            got = blocked_matvec(lay, x)
            assert got.shape == x.shape and got.dtype == torch.float32
            torch.testing.assert_close(got, blocked_matvec_plain(lay, x), rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
    assert (csr_spmm.launches - k1, blocked_matvec.launches - bm) == (4, 4)


@pytest.mark.gpu
def test_blocked_spmm_backward_on_card_matches_cpu(cuda_device):
    """The blocked spmm's forward and dx (blocked_matvec over t_blocked) on
    the card against the CPU path; the CSR K1 on the card agrees too."""
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
    dh (the first hop's too: its input is ``lin``'s output), K2 for the
    denominator and for the destination gather's VJP, K1 for the source
    gather's VJP."""
    from gnn_tpu_torch.graphs import NeighborSampler
    from gnn_tpu_torch.models import GAT, GIN, GraphSAGE

    data = tg.stochastic_block_model(num_nodes=300, num_classes=4, feature_dim=12, seed=1)
    make = {
        "sage": lambda gen: GraphSAGE(12, 32, 4, dropout=0.0, generator=gen),
        "sage-max": lambda gen: GraphSAGE(12, 32, 4, aggr="max", dropout=0.0, generator=gen),
        "gat": lambda gen: GAT(12, 8, 4, heads=4, dropout=0.0, generator=gen),
        "gin": lambda gen: GIN(12, 32, 4, num_layers=2, generator=gen),
    }[name]
    want = {"sage": (3, 0, 0), "sage-max": (0, 0, 0), "gat": (2, 4, 4), "gin": (3, 0, 0)}[name]
    sampler = NeighborSampler(data, [5, 3])
    nodes, adjs = sampler.sample(torch.Generator().manual_seed(0), torch.arange(64))
    cpu = make(torch.Generator().manual_seed(0))
    gpu = make(None).to(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    on_card = sampler.to(cuda_device)
    before = (csr_spmm.launches, segment_sum_csr.launches, csr_spmm_heads.launches)
    out_gpu = gpu.forward_sampled(data.x[nodes].to(cuda_device), on_card.adjacencies(64))
    out_gpu.square().sum().backward()
    after = (csr_spmm.launches, segment_sum_csr.launches, csr_spmm_heads.launches)
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
