"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_CURRENT = contextlib.nullcontext()

_FEATURE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Bytes of one 4-feature vector load: the kernels take the vector path only
# when every row starts on such a boundary.
_VEC_BYTES = {torch.float32: 16, torch.bfloat16: 8}


def check_index(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got {t.dtype} {tuple(t.shape)}")


def check_features(name: str, t: torch.Tensor) -> str:
    """Returns the kernel suffix for t's dtype."""
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor, got {tuple(t.shape)}")
    if t.dtype not in _FEATURE_DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return _FEATURE_DTYPES[t.dtype]


def check_weight(w: Optional[torch.Tensor], num_edges: int, device: torch.device) -> None:
    if w is None:
        return
    if w.device != device:
        raise ValueError(f"weight is on {w.device}, expected {device}")
    if w.dtype != torch.float32 or w.shape != (num_edges,) or not w.is_contiguous():
        raise ValueError(f"weight must be a contiguous float32 [{num_edges}] tensor, got {w.dtype} {tuple(w.shape)}")


def vector_path(*tensors: torch.Tensor) -> int:
    """1 when every row of every tensor starts on a vector-load boundary."""
    t0 = tensors[0]
    align = _VEC_BYTES[t0.dtype]
    ok = t0.shape[1] % 4 == 0 and all(t.data_ptr() % align == 0 for t in tensors)
    return int(ok)


def on(device: torch.device):
    """``torch.cuda.device(device)``, or one shared null context where
    ``device`` is already the current card: a launch then spares the host
    the guard's device switch and its way back."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, read without building
    a ``torch.cuda.Stream`` object on every launch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def reduce_scratch(lib, n_rows: int, n_edges: int, F: int, device: torch.device) -> tuple:
    """The kernels' scratch: a float32 partial of F features (K3: of all its
    heads) and its row for the head and the tail of every merge-path warp
    tile."""
    tiles = lib.gnn_csr_reduce_tiles(n_rows, n_edges)
    if tiles < 0:
        raise ValueError(f"{n_rows} rows + {n_edges} edges exceed the kernels' int32 merge coordinates")
    part = torch.empty(2 * tiles * F, dtype=torch.float32, device=device)
    part_row = torch.empty(2 * tiles, dtype=torch.int32, device=device)
    return part, part_row


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {rc}")


def row_ids(row_ptr: torch.Tensor, num_entries: int) -> torch.Tensor:
    """The row of each CSR entry, int64 [E] (for the plain versions)."""
    n_rows = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n_rows, device=row_ptr.device), counts, output_size=num_entries
    )
