"""Reading a ``torch.profiler`` trace of the card.

Frozen copies of ``gnn_tpu_torch/utils/profiling.py``'s ``device_kernels``,
``union_us`` and ``kernel_of`` (with its ``KERNEL_OPS``), and of
``tools/profile_gcn_step.py``'s names of the library's matrix products.
"""

from __future__ import annotations

from typing import Optional

import torch

# The Op in a hand-written kernel's name -> the port's kernel. GatherHeads
# first: "gnn::Gather" is a prefix of it.
KERNEL_OPS = (("gnn::GatherHeads", "K3"), ("gnn::Gather", "K1"), ("gnn::Contiguous", "K2"))
# Substrings of the names of the library's matrix-product kernels.
GEMM_NAMES = ("gemm", "cutlass", "xmma", "cublas", "gemv")


def on_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def device_kernels(events) -> list:
    """The device's own activity (kernels, copies, memsets): user
    annotations on the device span the gaps between the kernels they
    cover, so they are left out."""
    return [e for e in events if on_device(e) and not getattr(e, "is_user_annotation", False)]


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def kernel_of(name: str) -> Optional[str]:
    """K1, K2 or K3 by the Op in a kernel's name, else None."""
    return next((label for op, label in KERNEL_OPS if op in name), None)


def is_gemm(name: str) -> bool:
    return kernel_of(name) is None and any(sub in name.lower() for sub in GEMM_NAMES)


def duration_us(e) -> float:
    return e.time_range.end - e.time_range.start


def device_ranges(events, names) -> list:
    """(start, end) of the device-side annotation ranges named in ``names``."""
    return [
        (e.time_range.start, e.time_range.end) for e in events
        if on_device(e) and getattr(e, "is_user_annotation", False) and e.name in names
    ]


def host_ranges(events, names) -> list:
    """The host-side ``record_function`` ranges named in ``names``."""
    return [e for e in events if not on_device(e) and e.name in names]
