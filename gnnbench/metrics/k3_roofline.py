"""K3's (gnn::GatherHeads) least time over its device time, in %: the
calls counted by the port's ``csr_spmm_heads.launches``, sized from the
cell's shapes."""

from gnnbench.metrics import roofline


def read(t):
    return roofline(t, "K3", "csr_spmm_heads")
