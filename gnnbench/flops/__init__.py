"""Operations of one training step and the least time of its hand-written
kernels' calls, from the configuration's shapes: one module per model family,
named by a configuration's ``flops`` key.

``shapes`` is what the harness worked out from the cell: ``nodes``,
``edges`` (with the self loops the port adds), ``features``, ``classes``
and, for a sampled cell, ``hops``: (destinations, sources, edges) of each
layer's bipartite hop, outermost first. A full-graph layer has
``nodes`` destinations and sources and ``edges`` edges.
"""


def layer_graphs(shapes: dict, num_layers: int) -> list:
    """(destinations, sources, edges) of each layer, first layer first."""
    if "hops" in shapes:
        return [tuple(h) for h in shapes["hops"]]
    return [(shapes["nodes"], shapes["nodes"], shapes["edges"])] * num_layers


def linear_flops(rows: int, d_in: int, d_out: int, first: bool) -> float:
    """X W^T forward and its weight gradient, and its input gradient except
    in the first layer, whose input is data."""
    return 2.0 * rows * d_in * d_out * (2 if first else 3)
