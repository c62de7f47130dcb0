"""K1's (gnn::Gather) least time over its device time, in %: the calls
counted by the port's ``csr_spmm.launches``, sized from the cell's shapes."""

from gnnbench.metrics import roofline


def read(t):
    return roofline(t, "K1", "csr_spmm")
