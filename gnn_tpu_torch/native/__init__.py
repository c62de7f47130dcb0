"""The C++ graph core, bound with ctypes.

The port compiles the JAX package's own source file,
``gnn_tpu/native/graph_native.cpp`` (read as a file; the ``gnn_tpu`` package
is never imported), with ``g++`` and the same flags, at first use, into
``build/gnn_tpu_torch/`` at the root of the checkout. The library's file name
carries a hash of the source, the flags and the host name (``-march=native``
makes the binary fit only the CPU it was built on), so an edited source, or
a library built elsewhere, is never loaded in its place. Every symbol is
bound at load; a missing ``g++``, a failed build or a missing symbol raises.

There is no numpy fallback: the JAX package's fallback label propagation
gives other labels than the native one, and the port's relabelled layouts
must equal the JAX package's.

Wrappers, with the JAX package's names and signatures: :func:`sort_edges_csr`,
:func:`degrees`, :func:`sample_neighbors_host` (the same source and seed give
the JAX package's draws exactly), :func:`label_propagation`,
:func:`cluster_pack` and :func:`refine_windows`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "load", "sort_edges_csr", "degrees", "sample_neighbors_host", "label_propagation", "cluster_pack",
    "refine_windows",
]

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO / "gnn_tpu" / "native" / "graph_native.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64, _U64, _F64 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_double
# name: (restype, argtypes), as declared in graph_native.cpp
_SIGNATURES = {
    "sort_edges_csr": (_I64, [_I64, _I64, _I64P, _I64P, _I64P, _I64P]),
    "degrees": (None, [_I64, _I64, _I64P, _F32P, _F64P]),
    "sample_neighbors": (None, [_I64P, _I64P, _I64, _I64P, _I64, _U64, _I64, _I64P]),
    "coalesce_sorted": (_I64, [_I64, _I64P, _I64P, _F32P, _I64P, _I64P, _F32P]),
    "partition_by_edges": (None, [_I64, _I64, _I64P, _I64P]),
    "label_propagation": (_I64, [_I64, _I64P, _I64P, _F32P, _I64, _I64, _U64, _I64P]),
    "cluster_pack": (None, [_I64, _I64, _I64P, _I64, _I64P]),
    "refine_windows": (_I64, [_I64, _I64P, _I64P, _I64, _I64, _I64P]),
    "louvain_cluster": (_I64, [_I64, _I64P, _I64P, _F32P, _I64, _I64, _I64, _F64, _U64, _I64P]),
}

_lock = threading.Lock()
_lib = None


def _build() -> pathlib.Path:
    if not _SRC.exists():
        raise RuntimeError(f"the graph core's source {_SRC} is missing")
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's graph core is C++ built at first use")
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(platform.node().encode())
    digest.update(_SRC.read_bytes())
    out_dir = _REPO / "build" / "gnn_tpu_torch"
    lib_path = out_dir / f"libgraph_native_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The graph core's library, built on first call, every symbol bound."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build()
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                try:
                    fn = getattr(lib, name)
                except AttributeError:
                    raise RuntimeError(f"{path} lacks the symbol '{name}'; delete it to rebuild") from None
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _ptr(a: Optional[np.ndarray], typ):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(typ))


def _check_csr(row_ptr: np.ndarray, col: np.ndarray) -> None:
    n = len(row_ptr) - 1
    if n < 0 or row_ptr[0] != 0 or row_ptr[-1] != len(col) or (np.diff(row_ptr) < 0).any():
        raise ValueError("row_ptr must be CSR offsets over col")
    if len(col) and (col.min() < 0 or col.max() >= n):
        raise ValueError(f"col ids must lie in [0, {n})")


def sort_edges_csr(src, dst, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stable (dst major, src minor) edge sort. Returns (perm, row_ptr)."""
    src, dst = _i64(src), _i64(dst)
    perm = np.empty(len(src), np.int64)
    row_ptr = np.empty(num_nodes + 1, np.int64)
    rc = load().sort_edges_csr(
        num_nodes, len(src), _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
        _ptr(perm, ctypes.c_int64), _ptr(row_ptr, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError("edge ids out of range")
    return perm, row_ptr


def degrees(nodes, num_nodes: int, weight=None) -> np.ndarray:
    """Per-node count of the ids in ``nodes`` (or sum of ``weight``, float32
    values, one per id), float64 [num_nodes]."""
    nodes = _i64(nodes)
    if len(nodes) and (nodes.min() < 0 or nodes.max() >= num_nodes):
        raise ValueError(f"node ids must lie in [0, {num_nodes})")
    w = None if weight is None else np.ascontiguousarray(weight, np.float32)
    if w is not None and w.shape != nodes.shape:
        raise ValueError(f"weight must have one value per id, got {w.shape}")
    out = np.zeros(num_nodes, np.float64)
    load().degrees(
        num_nodes, len(nodes), _ptr(nodes, ctypes.c_int64), _ptr(w, ctypes.c_float),
        _ptr(out, ctypes.c_double),
    )
    return out


def sample_neighbors_host(
    row_ptr, col, seeds, fanout: int, *, seed: int = 0, replace: bool = True
) -> np.ndarray:
    """Uniform neighbour sampling on the host: ``fanout`` draws per seed from
    its CSR row, int64 [S, fanout]. A seed without neighbours gets itself in
    slot 0 and -1 in the others; without replacement a row shorter than
    ``fanout`` is padded with -1."""
    row_ptr, col, seeds = _i64(row_ptr), _i64(col), _i64(seeds)
    n = len(row_ptr) - 1
    if len(seeds) and (seeds.min() < 0 or seeds.max() >= n):
        raise ValueError(f"seed ids must lie in [0, {n})")
    # Only the seeds' rows are read, so only they are checked: a pass over
    # the whole CSR on every batch would cost more than the draws.
    lo, hi = row_ptr[seeds], row_ptr[seeds + 1]
    if ((lo < 0) | (hi < lo) | (hi > len(col))).any():
        raise ValueError("row_ptr must be CSR offsets over col")
    out = np.empty((len(seeds), int(fanout)), np.int64)
    load().sample_neighbors(
        _ptr(row_ptr, ctypes.c_int64), _ptr(col, ctypes.c_int64), len(seeds),
        _ptr(seeds, ctypes.c_int64), int(fanout), ctypes.c_uint64(seed), 1 if replace else 0,
        _ptr(out, ctypes.c_int64),
    )
    return out


def label_propagation(
    row_ptr,
    col,
    *,
    weight=None,
    n_iters: int = 10,
    max_size: int = 0,
    seed: int = 0,
) -> Tuple[np.ndarray, int]:
    """Size-capped label propagation over a CSR graph (labels start as node
    ids; each sweep adopts the neighbourhood's plurality label, skipping
    communities already at ``max_size``). Returns ``(label [N] int64
    compacted to 0..k-1, k)``."""
    row_ptr, col = _i64(row_ptr), _i64(col)
    n_nodes = len(row_ptr) - 1
    _check_csr(row_ptr, col)
    out = np.empty(n_nodes, np.int64)
    w = None if weight is None else np.ascontiguousarray(weight, np.float32)
    if w is not None and w.shape != col.shape:
        raise ValueError(f"weight must have one value per entry of col, got {w.shape}")
    k = load().label_propagation(
        n_nodes, _ptr(row_ptr, ctypes.c_int64), _ptr(col, ctypes.c_int64),
        _ptr(w, ctypes.c_float), n_iters, max_size, ctypes.c_uint64(seed),
        _ptr(out, ctypes.c_int64),
    )
    return out, int(k)


def refine_windows(row_ptr, col, win, n_windows: int, *, n_sweeps: int = 2) -> Tuple[np.ndarray, int]:
    """Greedy pairwise swaps of nodes between windows (window sizes fixed)
    that raise the intra-window edge fraction; votes use the in-edges of the
    CSR. Returns (new win, swap count)."""
    row_ptr, col = _i64(row_ptr), _i64(col)
    _check_csr(row_ptr, col)
    win = np.array(win, np.int64)
    if win.shape != (len(row_ptr) - 1,) or (len(win) and (win.min() < 0 or win.max() >= n_windows)):
        raise ValueError(f"win must hold one window id in [0, {n_windows}) per node")
    swaps = load().refine_windows(
        len(row_ptr) - 1, _ptr(row_ptr, ctypes.c_int64), _ptr(col, ctypes.c_int64),
        int(n_windows), int(n_sweeps), _ptr(win, ctypes.c_int64),
    )
    return win, int(swaps)


def cluster_pack(labels, rows: int) -> np.ndarray:
    """First-fit-decreasing packing of label groups into ``rows``-node
    windows. Returns the new -> old node permutation."""
    labels = _i64(labels)
    n = len(labels)
    if n and labels.min() < 0:
        raise ValueError("labels must be non-negative")
    out = np.empty(n, np.int64)
    load().cluster_pack(
        n, int(labels.max()) + 1 if n else 0, _ptr(labels, ctypes.c_int64), int(rows),
        _ptr(out, ctypes.c_int64),
    )
    return out
