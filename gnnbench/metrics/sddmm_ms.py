"""Device ms per step inside the port's ``spmm_heads.dw`` range: GAT's
attention-weight gradient (the SDDMM d ex) in K3's backward."""

from gnnbench import trace as tr
from gnnbench.metrics import device_ms_per_step


def read(t):
    ranges = tr.device_ranges(t.events, {"spmm_heads.dw"})
    if not ranges:
        return None
    inside = lambda e: any(lo <= e.time_range.start and e.time_range.end <= hi for lo, hi in ranges)
    return device_ms_per_step(t, inside) or None
