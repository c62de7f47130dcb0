"""Timing, traces and roofline accounting.

Port of ``gnn_tpu/utils/profiling.py``:

* :func:`time_fn`: seconds per call, synchronised: CUDA events around the
  calls where the result lies on the card, ``perf_counter`` where it lies
  on the CPU;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace;
* reading such a trace: :func:`device_kernels` (the device's own
  activity), :func:`union_us` (busy time, overlaps counted once),
  :func:`kernel_of` (K1, K2 or K3 by the Op in a kernel's name) and
  :func:`split_by_range` (the kernels inside annotation ranges such as
  ``halo.exchange``); ``tools/profile_gcn_step.py`` and ``chip_smoke.py
  --cards N`` read their traces with them;
* :class:`Chip` and :class:`Roofline`: bytes and operations of a call,
  scored against a card's peak rates. The card is :data:`H100` (NVIDIA's
  data sheet for the SXM part at its full 700 W: 3.35 TB/s, 67 TFLOP/s in
  float32 outside the tensor cores, 989 TFLOP/s dense bf16; the figures of
  ``ops/cuda/bounds.py``). It replaces the JAX package's ``TPU_V5E``, a TPU
  figure the port does not carry.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gnn_tpu_torch.ops.cuda import bounds

__all__ = [
    "time_fn", "trace", "device_kernels", "union_us", "kernel_of", "split_by_range", "KERNEL_OPS", "Chip", "Roofline",
    "H100",
]


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls. Where the
    first tensor of the result lies on the card, CUDA events on its current
    stream time the ``iters`` calls (the host waits for the end event);
    otherwise the host clock does. Only as honest as ``fn``'s dataflow: a
    call whose result nothing reads still runs here, but it may read a cache
    that the real caller would find cold."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        with torch.cuda.device(t.device):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('profile'): step()`` writes ``log_dir/trace.json``, a
    Chrome trace of the host's and (where there is a card) the device's
    activity. Yields the ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# The Op in a kernel's name -> the port's kernel.
KERNEL_OPS = (("gnn::GatherHeads", "K3 csr_reduce_* GatherHeads"), ("gnn::Gather", "K1 csr_reduce_* Gather"),
              ("gnn::Contiguous", "K2 csr_reduce_* Contiguous"))


def _on_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def device_kernels(prof_events) -> list:
    """The device's own activity in a ``torch.profiler`` trace: user
    annotations (e.g. "Optimizer.step#Adam.step") span the gaps between the
    kernels they cover, so they are left out."""
    return [e for e in prof_events if _on_device(e) and not getattr(e, "is_user_annotation", False)]


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
    """The label of ``KERNEL_OPS`` whose Op the kernel's name holds, else None."""
    return next((label for op, label in KERNEL_OPS if op in name), None)


def split_by_range(prof_events, kernels, steps: int, inside: dict) -> dict:
    """Device ms and launches per step of the kernels inside the annotation
    ranges on the device that ``inside`` names (keyed by ``inside[range
    name](kernel name)``), of K1, K2, K3 and of the rest. Empty where the
    trace holds no such range."""
    ranges = [
        (e.time_range.start, e.time_range.end, e.name) for e in prof_events
        if _on_device(e) and getattr(e, "is_user_annotation", False) and e.name in inside
    ]
    if not ranges:
        return {}
    out = defaultdict(lambda: [0.0, 0.0])
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        held_by = next((name for lo, hi, name in ranges if lo <= start and end <= hi), None)
        key = inside[held_by](e.name) if held_by is not None else kernel_of(e.name) or "rest"
        out[key][0] += (end - start) / 1e3 / steps
        out[key][1] += 1 / steps
    return dict(out)


@dataclass(frozen=True)
class Chip:
    name: str
    hbm_gbps: float
    bf16_tflops: float
    f32_tflops: float


H100 = Chip(
    name="H100",
    hbm_gbps=bounds.H100_BYTES_PER_S / 1e9,
    bf16_tflops=bounds.H100_BF16_FLOPS / 1e12,
    f32_tflops=bounds.H100_F32_FLOPS / 1e12,
)


@dataclass
class Roofline:
    """Accumulate bytes and flops for an op, then score a measured time."""

    bytes_accessed: float = 0.0
    flops: float = 0.0
    chip: Chip = H100

    def add_read(self, *shapes_dtypes):
        """Each argument a (shape, dtype) pair; dtype a numpy or torch dtype."""
        for shape, dtype in shapes_dtypes:
            size = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
            self.bytes_accessed += float(np.prod(shape)) * size
        return self

    add_write = add_read  # same accounting

    def add_matmul(self, m, k, n, passes: int = 1):
        self.flops += 2.0 * m * k * n * passes
        return self

    @property
    def memory_time_s(self) -> float:
        return self.bytes_accessed / (self.chip.hbm_gbps * 1e9)

    def compute_time_s(self, dtype="bfloat16") -> float:
        peak = self.chip.bf16_tflops if dtype in ("bfloat16", torch.bfloat16) else self.chip.f32_tflops
        return self.flops / (peak * 1e12)

    def fraction_of_peak(self, measured_s: float, dtype="bfloat16") -> float:
        sol = max(self.memory_time_s, self.compute_time_s(dtype))
        return sol / max(measured_s, 1e-12)
