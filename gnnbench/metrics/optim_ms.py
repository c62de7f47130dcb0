"""Device ms per step inside the port's ``optim.step`` and
``optim.zero_grad`` spans: every per-leaf kernel of the optimizer's
update."""

from gnnbench.metrics._spans import device_ms_inside


def read(t):
    return device_ms_inside(t, {"optim.step", "optim.zero_grad"})
