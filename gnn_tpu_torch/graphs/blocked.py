"""Cluster-packed block-diagonal layout: dense windows plus a CSR remainder.

Port of ``gnn_tpu/graphs/blocked.py``. After a community-aware relabelling
(size-capped label propagation in the native graph core, first-fit-decreasing
packing of the communities into windows of exactly R nodes, boundary
refinement, then a sort within each window by descending remainder degree),
edges whose source and destination share a window are baked into
``diag [B, R, R]`` and aggregate as one batched matrix product; the
inter-window remainder is a dst-sorted CSR that kernel K1
(``ops/cuda/spmm.py``) reduces, fusing the gather ``x[rem_src] * rem_w`` with
the per-destination sum.

The JAX package's TPU remainder machinery (the leveled-ELL ``RemLevel``
tables and tails, the bucket slot tables, the chunk plan and the ns cost
model choosing between them) is not ported: every ``rem_backend`` builds the
same CSR. Like the JAX layout this is a static-weight layout: attention
needs the plain CSR.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F_

from gnn_tpu_torch import native
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain
from gnn_tpu_torch.utils.tracing import span

__all__ = [
    "BlockedLayout",
    "cluster_order",
    "cluster_pack_order",
    "cluster_pack_order_plain",
    "refine_window_order",
    "refine_pack_order",
    "build_blocked",
    "refresh_blocked_weights",
    "blocked_matvec",
    "blocked_matvec_plain",
]

DEFAULT_R = 256
_REM_BACKENDS = ("auto", "bucket", "levels", "kernel")


@dataclasses.dataclass(frozen=True)
class BlockedLayout:
    """Block-diagonal dense part and CSR remainder, in the packed node order."""

    diag: torch.Tensor  # [B, R, R]; diag[b, r, c] = w(edge b*R+c -> b*R+r), 0 where none
    diag_pos: torch.Tensor  # [E_d] int64 flat B*R*R position per dense edge
    diag_eid: torch.Tensor  # [E_d] int32 canonical edge id per dense edge
    rem_row_ptr: torch.Tensor  # [N + 1] int32 CSR offsets over rem_dst
    rem_src: torch.Tensor  # [E_r] int32 remainder sources
    rem_dst: torch.Tensor  # [E_r] int32 remainder destinations, ascending
    rem_w: Optional[torch.Tensor]  # [E_r] float32, or None for ones
    rem_eid: torch.Tensor  # [E_r] int32 canonical edge ids
    num_nodes: int
    rows: int

    @property
    def num_blocks(self) -> int:
        return int(self.diag.shape[0])

    @property
    def num_dense_edges(self) -> int:
        return int(self.diag_eid.shape[0])

    @property
    def num_rem_edges(self) -> int:
        return int(self.rem_src.shape[0])

    def to(self, device) -> "BlockedLayout":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def cluster_order(
    edge_index,
    num_nodes: int,
    *,
    max_size: int = 0,
    n_iters: int = 10,
    seed: int = 0,
    pack_rows: int = 0,
    refine_sweeps: int = 2,
) -> np.ndarray:
    """Node permutation (new -> old) grouping nodes by the communities that
    label propagation finds, communities in node-id order. ``pack_rows=R``
    packs them into windows of exactly R nodes instead
    (:func:`cluster_pack_order`, community size cap R) and refines the window
    boundaries with ``refine_sweeps`` swap sweeps (0 disables)."""
    if pack_rows and max_size and max_size != pack_rows:
        raise ValueError(
            f"cluster_order: pack_rows={pack_rows} forces the community size cap, "
            f"conflicting with max_size={max_size}; pass only one"
        )
    ei = np.asarray(edge_index)
    order0, rp0 = native.sort_edges_csr(ei[0], ei[1], num_nodes)
    col = ei[0].astype(np.int64)[order0]
    labels, _ = native.label_propagation(
        rp0, col, max_size=pack_rows if pack_rows else max_size, n_iters=n_iters, seed=seed
    )
    if pack_rows:
        perm = cluster_pack_order(labels, int(pack_rows))
        return refine_window_order(perm, int(pack_rows), row_ptr=rp0, col=col, n_sweeps=refine_sweeps)
    return np.argsort(labels, kind="stable")


def cluster_pack_order(labels, rows: int) -> np.ndarray:
    """Node permutation (new -> old) packing label groups into windows of
    exactly ``rows`` nodes: first-fit-decreasing bin packing of the groups
    (groups larger than a window chopped into window-size chunks first),
    full bins first, then the underfull bins concatenated and cut at window
    boundaries, so each boundary splits at most one community. Runs the
    native graph core's segment-tree first fit; :func:`cluster_pack_order_plain`
    is the same packing as a Python scan."""
    labels = np.asarray(labels, np.int64)
    if len(labels) == 0:
        return np.zeros(0, np.int64)
    return native.cluster_pack(labels, int(rows))


def cluster_pack_order_plain(labels, rows: int) -> np.ndarray:
    """The plain version of :func:`cluster_pack_order`: an O(C x B) Python
    first-fit scan, equal to the native packing."""
    labels = np.asarray(labels, np.int64)
    n = len(labels)
    order_by_label = np.argsort(labels, kind="stable")
    counts = np.bincount(labels) if n else np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    chunks = []  # (start offset into order_by_label, size)
    for c in range(len(counts)):
        s, size = int(starts[c]), int(counts[c])
        while size > rows:
            chunks.append((s, rows))
            s += rows
            size -= rows
        if size:
            chunks.append((s, size))
    chunks.sort(key=lambda t: -t[1])  # big chunks first; small ones plug the gaps
    bins: list = []
    space: list = []
    for ch in chunks:
        for i in range(len(bins)):
            if space[i] >= ch[1]:
                bins[i].append(ch)
                space[i] -= ch[1]
                break
        else:
            bins.append([ch])
            space.append(rows - ch[1])
    full = [b for b, sp in zip(bins, space) if sp == 0]
    part = [b for b, sp in zip(bins, space) if sp != 0]
    perm = np.empty(n, np.int64)
    off = 0
    for b in full + part:
        for s, size in b:
            perm[off : off + size] = order_by_label[s : s + size]
            off += size
    assert off == n
    return perm


def refine_window_order(perm, rows: int, *, row_ptr, col, n_sweeps: int = 2) -> np.ndarray:
    """Boundary-refine a packed window order with the native graph core's
    greedy swaps (window sizes preserved; order within a window kept).
    ``row_ptr``/``col`` are the dst-major CSR over the original node ids;
    ``perm`` is new -> old."""
    perm = np.asarray(perm, np.int64)
    n = len(perm)
    if n == 0 or n_sweeps <= 0:
        return perm
    old2new = np.empty(n, np.int64)
    old2new[perm] = np.arange(n)
    R = int(rows)
    win, swaps = native.refine_windows(row_ptr, col, old2new // R, -(-n // R), n_sweeps=n_sweeps)
    if swaps == 0:
        return perm
    # swaps are pairwise, so a stable re-sort keeps every window's size
    return perm[np.argsort(win[perm], kind="stable")]


def refine_pack_order(perm, src, dst, rows: int) -> np.ndarray:
    """Re-sort nodes within each R-row window by descending remainder
    (inter-window) in-degree. Window membership, and so the dense/remainder
    split, does not change. ``src``/``dst`` are original-id edges."""
    perm = np.asarray(perm, np.int64)
    n = len(perm)
    old2new = np.empty(n, np.int64)
    old2new[perm] = np.arange(n)
    s, d = old2new[np.asarray(src, np.int64)], old2new[np.asarray(dst, np.int64)]
    R = int(rows)
    deg = np.bincount(d[s // R != d // R], minlength=n)
    return perm[np.lexsort((-deg, np.arange(n) // R))]


def build_blocked(
    src,
    dst,
    edge_ids,
    num_nodes: int,
    num_edges: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    rows: int = DEFAULT_R,
    block_dtype: Optional[torch.dtype] = None,
    rem_backend: str = "auto",
) -> BlockedLayout:
    """Build from packed-id edges in dst-sorted order. ``edge_ids`` are each
    edge's canonical (adjacency-order) id; ``edge_weight`` is indexed by
    canonical id. ``rem_backend`` is checked for the JAX package's values;
    all of them build the same CSR remainder."""
    if rem_backend not in _REM_BACKENDS:
        raise ValueError(f"unknown rem_backend '{rem_backend}'")
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    eid = np.asarray(edge_ids, np.int64)
    if len(eid):
        w = (np.ones(num_edges, np.float32) if edge_weight is None
             else np.asarray(edge_weight, np.float32))[eid]
    else:
        w = np.zeros(0, np.float32)
    R = int(rows)
    B = max(1, -(-num_nodes // R))

    dense = src // R == dst // R
    dpos = (dst[dense] // R) * R * R + (dst[dense] % R) * R + (src[dense] % R)
    D = np.zeros(B * R * R, np.float32)
    np.add.at(D, dpos, w[dense])
    keep = ~dense
    rem_src, rem_dst = src[keep], dst[keep]
    rem_row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rem_dst, minlength=num_nodes))])

    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    diag = torch.from_numpy(D.reshape(B, R, R))
    return BlockedLayout(
        diag=diag if block_dtype is None else diag.to(block_dtype),
        diag_pos=torch.from_numpy(dpos),
        diag_eid=i32(eid[dense]),
        rem_row_ptr=i32(rem_row_ptr),
        rem_src=i32(rem_src),
        rem_dst=i32(rem_dst),
        rem_w=None if edge_weight is None else torch.from_numpy(np.ascontiguousarray(w[keep])),
        rem_eid=i32(eid[keep]),
        num_nodes=int(num_nodes),
        rows=R,
    )


def refresh_blocked_weights(
    lay: BlockedLayout, weight: Optional[torch.Tensor], num_edges: int
) -> BlockedLayout:
    """Re-bake the block and remainder weights after an edge-weight swap
    (layout constants, not a gradient path). ``weight`` is in canonical
    edge order; None means ones."""
    dev = lay.diag.device
    w = torch.ones(num_edges, device=dev) if weight is None else weight.detach().float().to(dev)
    B, R, _ = lay.diag.shape
    D = torch.zeros(B * R * R, device=dev).index_add_(0, lay.diag_pos, w[lay.diag_eid.long()])
    return dataclasses.replace(
        lay,
        diag=D.view(B, R, R).to(lay.diag.dtype),
        rem_w=None if weight is None and lay.rem_w is None else w[lay.rem_eid.long()].contiguous(),
    )


def _diag_product(diag: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """The block-diagonal product in float32, as the JAX einsum's
    ``preferred_element_type``. float32 blocks: ``torch.bmm``. bfloat16
    blocks on the card: ``torch.bmm(..., out_dtype=torch.float32)`` (bf16
    operands, float32 sums and output). On the CPU, where that overload has
    no kernel: the bf16-rounded operands multiplied in float32."""
    if diag.dtype == torch.float32:
        return torch.bmm(diag, xw)
    if diag.is_cuda:
        return torch.bmm(diag, xw, out_dtype=torch.float32)
    return torch.bmm(diag.float(), xw.float())


def _blocked_matvec(lay: BlockedLayout, x: torch.Tensor, spmm_fn) -> torch.Tensor:
    N, F = x.shape
    B, R, _ = lay.diag.shape
    # a span around the block product: tools/profile_gcn_step.py splits the
    # step's device time by it
    with span("blocked_matvec.diag"):
        xw = F_.pad(x, (0, 0, 0, B * R - N)).view(B, R, F).to(lay.diag.dtype)
        out = _diag_product(lay.diag, xw).view(B * R, F)[:N].to(x.dtype)
    if lay.num_rem_edges:
        out = out + spmm_fn(lay.rem_row_ptr, lay.rem_src, lay.rem_w, x)
    return out


def blocked_matvec_plain(lay: BlockedLayout, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`blocked_matvec`: the same block product, the
    remainder through K1's plain version."""
    return _blocked_matvec(lay, x.contiguous(), csr_spmm_plain)


def blocked_matvec(lay: BlockedLayout, x: torch.Tensor) -> torch.Tensor:
    """out[d] = sum over in-edges (s -> d) of w * x[s]: the windows as one
    batched product in float32 (cast to x's dtype), plus the remainder
    through K1 in x's dtype, as ``gnn_tpu/graphs/blocked.py:603`` casts and
    adds. An empty remainder launches no kernel. CPU tensors take the plain
    version; on the card each call counts in ``blocked_matvec.launches``."""
    if x.device.type == "cpu":
        return blocked_matvec_plain(lay, x)
    if x.device.type != "cuda":
        raise ValueError(f"blocked_matvec runs on CUDA or CPU tensors, got {x.device}")
    if lay.diag.device != x.device:
        raise ValueError(f"the layout is on {lay.diag.device}, x on {x.device}")
    out = _blocked_matvec(lay, x.contiguous(), csr_spmm)
    blocked_matvec.launches += 1
    return out


blocked_matvec.launches = 0

