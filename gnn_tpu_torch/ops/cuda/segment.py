"""K2: the CSR segment-sum kernel (``csrc/segment_sum.cu``) and its plain
version.

Port of ``gnn_tpu/ops/pallas/segment.py::segment_sum_sorted``: out[n] = sum of
the dst-sorted message rows of segment n, float32 accumulation, output in
msg's dtype, empty segments 0. The segments are given by CSR offsets
``row_ptr`` instead of the TPU kernel's chunk plan.

:func:`segment_sum_csr` launches the kernel for CUDA tensors and takes
:func:`segment_sum_csr_plain` only for CPU tensors. It counts its launches in
``segment_sum_csr.launches``.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.ops.cuda import _build, _launch

__all__ = ["segment_sum_csr", "segment_sum_csr_plain"]


def segment_sum_csr_plain(row_ptr: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``index_add_`` in float32, then a cast."""
    out = torch.zeros((row_ptr.numel() - 1, msg.shape[1]), dtype=torch.float32, device=msg.device)
    out.index_add_(0, _launch.row_ids(row_ptr, msg.shape[0]), msg.float())
    return out.to(msg.dtype)


def segment_sum_csr(row_ptr: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_{k in [row_ptr[r], row_ptr[r+1])} msg[k]; msg [E, F]
    float32 or bfloat16, int32 ``row_ptr`` [N + 1]."""
    if msg.device.type == "cpu":
        return segment_sum_csr_plain(row_ptr, msg)
    if msg.device.type != "cuda":
        raise ValueError(f"segment_sum_csr runs on CUDA or CPU tensors, got {msg.device}")
    suffix = _launch.check_features("msg", msg)
    _launch.check_index("row_ptr", row_ptr, msg.device)
    n_rows, (n_edges, F) = row_ptr.numel() - 1, msg.shape
    out = torch.empty((n_rows, F), dtype=msg.dtype, device=msg.device)
    if n_rows == 0 or F == 0:
        return out
    lib = _build.load()
    with _launch.on(msg.device):
        part, part_row = _launch.reduce_scratch(lib, n_rows, n_edges, F, msg.device)
        rc = getattr(lib, f"gnn_segment_sum_{suffix}")(
            row_ptr.data_ptr(), msg.data_ptr(), out.data_ptr(), part.data_ptr(),
            part_row.data_ptr(), n_rows, n_edges, F,
            _launch.vector_path(msg, out), _launch.stream(msg.device),
        )
    _launch.raise_on_error("segment_sum_csr", rc)
    segment_sum_csr.launches += 1
    return out


segment_sum_csr.launches = 0
