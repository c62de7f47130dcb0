"""Community-packed node orders: the relabelling of ``reorder='cluster'``.

Port of the ordering half of ``gnn_tpu/graphs/blocked.py``: size-capped label
propagation in the native graph core, first-fit-decreasing packing of the
communities into windows of exactly R nodes, boundary refinement, and a sort
within each window by descending inter-window in-degree. The orders equal
the JAX package's element for element.

The JAX package aggregates over such an order through its blocked layout:
dense ``[B, R, R]`` windows beside a remainder. The port keeps the order
and drops the layout: on the H100, kernel K1 (``ops/cuda/spmm.py``) over the
whole relabelled CSR beat the block product in every measurement, so a
``reorder='cluster'`` adjacency is a CSR like any other.
"""

from __future__ import annotations

import numpy as np

from gnn_tpu_torch import native

__all__ = [
    "cluster_order",
    "cluster_pack_order",
    "cluster_pack_order_plain",
    "refine_window_order",
    "refine_pack_order",
]


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
    """Re-sort nodes within each R-row window by descending inter-window
    in-degree (the JAX layout's remainder degree). Window membership does not
    change. ``src``/``dst`` are original-id edges."""
    perm = np.asarray(perm, np.int64)
    n = len(perm)
    old2new = np.empty(n, np.int64)
    old2new[perm] = np.arange(n)
    s, d = old2new[np.asarray(src, np.int64)], old2new[np.asarray(dst, np.int64)]
    R = int(rows)
    deg = np.bincount(d[s // R != d // R], minlength=n)
    return perm[np.lexsort((-deg, np.arange(n) // R))]
