"""Structured per-step metrics.

Port of ``gnn_tpu/train/metrics.py``: a JSONL metrics logger and an edges/s
and steps/s counter. CUDA launches are asynchronous, so a host clock measures the device
only after a synchronisation: read :class:`Throughput` after one (in ``fit``,
``float(loss)`` is that sync).
"""

from __future__ import annotations

import json
import sys
import time

__all__ = ["MetricLogger", "Throughput"]


class MetricLogger:
    """Append-only JSONL metrics with optional stderr echo."""

    def __init__(self, path: str = "", echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None
        self.history = []

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            parts = [f"step {step}"]
            for k, v in metrics.items():
                parts.append(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}")
            print("  ".join(parts), file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()


class Throughput:
    """edges/s and steps/s since ``start``; read after a device sync."""

    def __init__(self, edges_per_step: int):
        self.edges_per_step = edges_per_step
        self.t0 = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def step(self):
        if self.t0 is None:
            self.start()
        self.steps += 1

    @property
    def edges_per_s(self) -> float:
        if not self.steps or self.t0 is None:
            return 0.0
        return self.steps * self.edges_per_step / max(time.perf_counter() - self.t0, 1e-9)

    @property
    def steps_per_s(self) -> float:
        if not self.steps or self.t0 is None:
            return 0.0
        return self.steps / max(time.perf_counter() - self.t0, 1e-9)
