"""Host ms per step inside the port's ``optim.step`` and
``optim.zero_grad`` spans: the optimizer's launches and ``zero_grad`` as
the host sees them."""

from gnnbench.metrics._spans import host_ms


def read(t):
    return host_ms(t, {"optim.step", "optim.zero_grad"})
