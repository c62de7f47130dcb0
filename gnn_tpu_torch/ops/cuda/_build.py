"""Build and load the hand-written CUDA kernels.

Each source in ``gnn_tpu_torch/csrc`` compiles with its own ``nvcc`` for
``sm_90a``, all started together, and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, into ``build/gnn_tpu_torch/`` at the root of
the checkout. The library's file name carries a hash of the sources and the
flags, so an edited source builds anew and an unchanged one is reused.
Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "load", "build_info"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# Compile flags of each source; the link adds "-shared".
NVCC_FLAGS = (
    *_ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib = None
_info: dict = {}

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_SIGNATURES = {
    # row_ptr, col, w, x, out, part, part_row, n_rows, n_edges, F, vec, stream
    "gnn_csr_spmm_f32": [_VOID] * 7 + [_INT] * 4 + [_VOID],
    "gnn_csr_spmm_bf16": [_VOID] * 7 + [_INT] * 4 + [_VOID],
    # row_ptr, msg, out, part, part_row, n_rows, n_edges, F, vec, stream
    "gnn_segment_sum_f32": [_VOID] * 5 + [_INT] * 4 + [_VOID],
    "gnn_segment_sum_bf16": [_VOID] * 5 + [_INT] * 4 + [_VOID],
    # n_rows, n_edges -> warp tiles of the kernels' scratch
    "gnn_csr_reduce_tiles": [_INT] * 2,
    # row_ptr, col, w, w_index, x, out, part, part_row, n_rows, n_edges, H, F, vec, stream
    "gnn_gat_spmm_f32": [_VOID] * 8 + [_INT] * 5 + [_VOID],
    "gnn_gat_spmm_bf16": [_VOID] * 8 + [_INT] * 5 + [_VOID],
    # dst, src, g, x, dw, n_edges, H, F, vec, stream
    "gnn_gat_sddmm_f32": [_VOID] * 5 + [_INT] * 4 + [_VOID],
    "gnn_gat_sddmm_bf16": [_VOID] * 5 + [_INT] * 4 + [_VOID],
    # dst, src, h_src, h_dst, att, s, n_edges, H, F, slope, vec, stream
    "gnn_gatv2_score_f32": [_VOID] * 6 + [_INT] * 3 + [_FLOAT, _INT, _VOID],
    # row_ptr, src, t_row_ptr, t_perm, t_col, ds, h_src, h_dst, att, dh_src, dh_dst, datt,
    # part, part_row, datt_part, n_dst, n_src, n_edges, H, F, slope, vec, stream
    "gnn_gatv2_score_bwd_f32": [_VOID] * 15 + [_INT] * 5 + [_FLOAT, _INT, _VOID],
    # row_ptr, e, ex, den, part, part_idx, n_rows, n_edges, H, vec, stream
    "gnn_edge_softmax_f32": [_VOID] * 6 + [_INT] * 4 + [_VOID],
    # dst, ex, g_ex, g_den, de, n_edges, H, vec, stream
    "gnn_edge_softmax_bwd_f32": [_VOID] * 5 + [_INT] * 3 + [_VOID],
    # h, att_src, att_dst, dst, src, a, e, n_nodes, n_edges, H, F, slope, round_src, stream
    "gnn_gat_score_f32": [_VOID] * 7 + [_INT] * 4 + [_FLOAT, _INT, _VOID],
    # h, att_src, att_dst, dst, src, a, de, row_ptr, t_row_ptr, t_perm, ds, d_dst, d_src, part,
    # part_row, n_nodes, n_dst, n_edges, H, F, slope, round_src, stream
    "gnn_gat_score_bwd_f32": [_VOID] * 15 + [_INT] * 5 + [_FLOAT, _INT, _VOID],
    # h, att_src, att_dst, d_dst, d_src, dh, datt, datt_part, n_nodes, n_dst, H, F, stream
    "gnn_gat_score_node_bwd_f32": [_VOID] * 8 + [_INT] * 4 + [_VOID],
    # n_nodes -> blocks of the backward's datt partials
    "gnn_gat_datt_parts": [_INT],
    # p, g, m, v (pointer arrays), sizes, n_leaves, scalars, decoupled, stream
    "gnn_adam_f32": [_VOID] * 5 + [_INT, _VOID, _INT, _VOID],
}


def build_dir() -> pathlib.Path:
    return _PKG.parent / "build" / "gnn_tpu_torch"


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build() -> pathlib.Path:
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = build_dir()
    lib_path = out_dir / f"libgnn_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        _info.update(path=str(lib_path), built=False, seconds=0.0, log="")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in cu]
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(o), str(p)]
                    for p, o in zip(cu, objs))
    ]
    log, failed = "", []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, lib_path)
    lib_path.with_suffix(".log").write_text(log)
    _info.update(path=str(lib_path), built=True, seconds=seconds, log=log)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_info() -> dict:
    """Path of the loaded library, whether this process built it, the build's
    seconds and nvcc's output (register and spill counts from ptxas)."""
    return dict(_info)
