"""Device ms per step of the library's matrix products (nn/linear.py's
x @ W^T, its dW and dX), by their kernel names."""

from gnnbench import trace as tr
from gnnbench.metrics import device_ms_per_step


def read(t):
    return device_ms_per_step(t, lambda e: tr.is_gemm(e.name)) or None
