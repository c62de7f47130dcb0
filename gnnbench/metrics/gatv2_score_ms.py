"""Device ms per step inside the port's ``agg.gatv2_score`` and
``agg.gatv2_score.bwd`` spans: GATv2's fused attention score, forward and
backward."""

from gnnbench.metrics._spans import device_ms_inside


def read(t):
    return device_ms_inside(t, ("agg.gatv2_score", "agg.gatv2_score.bwd"))
