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
