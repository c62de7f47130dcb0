"""Device ms per step in the aggregation ops: the port's spans ``agg.<op>``
(each single-device aggregation op's forward: the kernel, its index
gathers, the softmax's scatter-max) and ``agg.<op>.bwd`` (their autograd
backwards: K1's and K3's transposes, the SDDMM, the gathers' VJPs), with
the spans nested in them (``spmm_heads.dw``, ``blocked_matvec.diag``).
None without an ``agg.`` span (a program that has none)."""

from gnnbench.metrics._spans import device_ms_inside

NESTED = ("spmm_heads.dw", "blocked_matvec.diag")


def read(t):
    names = {e.name for e in t.events if e.name.startswith("agg.")}
    return device_ms_inside(t, names | set(NESTED)) if names else None
