"""Device ms per step inside the port's ``dropout`` span: each inverted
dropout's draw, compare and apply (``nn/dropout.py``; GAT's attention
dropout included)."""

from gnnbench.metrics._spans import device_ms_inside


def read(t):
    return device_ms_inside(t, {"dropout"})
