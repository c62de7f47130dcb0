"""The degree-bucket node order of ``gnn_tpu/graphs/sorted_ell.py``.

The JAX package relabels a degree-symmetric graph's nodes so that every
degree bucket of its combine-free sorted-ELL layout lands contiguously in
node order (``build_adjacency(reorder=True / 'auto')``). The port keeps that
relabelling, ``adj.perm`` element for element, because ``fit``'s default
``train.reorder='auto'`` runs in the relabelled node space and the tests hold
the port to the reference there. This module is the port's own copy of what
the order needs (``KMAX``, ``SUB``, ``NARROW_MAX``, ``_widths``,
``_effective_kmax``, ``_bucket_key``, ``degree_bucket_order``;
``gnn_tpu/graphs/sorted_ell.py:57-98``) and nothing else: the slot tables
(``SortedEllLayout``, ``NarrowBlock``, ``build_sorted_ell`` and its matvecs)
are TPU machinery, flat-gather chains sized for the TPU's gather unit. On the
H100 the relabelled CSR goes to kernel K1 (``ops/cuda/spmm.py``), whose
merge-path tiles balance the edges whatever the degrees.
"""

from __future__ import annotations

import numpy as np

__all__ = ["KMAX", "SUB", "NARROW_MAX", "degree_bucket_order"]

NARROW_MAX = 16
SUB = 8  # subrow width of the TPU layout's wide-bucket stream
KMAX = 512


def _widths(kmax: int = KMAX) -> np.ndarray:
    return np.asarray(
        sorted(set(range(1, NARROW_MAX + 1)) | {SUB * m for m in range(3, kmax // SUB + 1)}),
        np.int64,
    )


def _effective_kmax(deg_nonself: np.ndarray, kmax: int = KMAX) -> int:
    """kmax shrunk to the largest degree (never below the smallest wide
    width), rounded up to a layout width."""
    widths = _widths(kmax)
    k = int(min(kmax, max(int(deg_nonself.max()) if len(deg_nonself) else 1, 3 * SUB)))
    return int(widths[np.searchsorted(widths, k)])


def _bucket_key(deg_nonself: np.ndarray, kmax: int) -> np.ndarray:
    """Bucket index per node: -1 where the degree is a multiple of kmax
    (isolated nodes included), else the index of the smallest layout width
    >= (deg mod kmax)."""
    widths = _widths(kmax)
    rem = np.asarray(deg_nonself, np.int64) % kmax
    return np.where(rem == 0, -1, np.searchsorted(widths, rem))


def degree_bucket_order(deg_nonself: np.ndarray, kmax: int = KMAX) -> np.ndarray:
    """Node permutation (new -> old) grouping nodes by remainder bucket.

    A stable argsort, so the relative order within a bucket is kept. Nodes
    whose non-self degree is an exact multiple of the effective kmax
    (isolated nodes included) lead the order."""
    deg_nonself = np.asarray(deg_nonself, np.int64)
    return np.argsort(_bucket_key(deg_nonself, _effective_kmax(deg_nonself, kmax)), kind="stable")
