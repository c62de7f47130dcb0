"""Timing, traces and roofline accounting.

Port of ``gnn_tpu/utils/profiling.py``:

* :func:`time_fn`: seconds per call, synchronised: CUDA events around the
  calls where the result lies on the card, ``perf_counter`` where it lies
  on the CPU;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace;
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
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from gnn_tpu_torch.ops.cuda import bounds

__all__ = ["time_fn", "trace", "Chip", "Roofline", "H100"]


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
