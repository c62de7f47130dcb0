"""Device ms per step inside the port's ``agg.edge_softmax`` and
``agg.edge_softmax.bwd`` spans: the attention's softmax by destination (the
shift, exp and denominator, and its backward), forward and backward. None
in a program without those spans."""

from gnnbench.metrics._spans import device_ms_inside


def read(t):
    return device_ms_inside(t, ("agg.edge_softmax", "agg.edge_softmax.bwd"))
