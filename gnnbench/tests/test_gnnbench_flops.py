"""The FLOP counts and the kernels' bounds against hand counts on a tiny
graph: 5 nodes, 7 edges with the self loops, 3 features, 2 classes."""

from __future__ import annotations

import pytest

from gnnbench import bounds
from gnnbench.bench import load_module
from gnnbench.tests.conftest import ROOT

SHAPES = {"nodes": 5, "edges": 7, "features": 3, "classes": 2}
GCN = {"model": {"hidden": 4, "num_layers": 2}}
GAT = {"model": {"hidden": 4, "heads": 2, "num_layers": 2}}


def flops(name):
    return load_module(ROOT / "gnnbench" / "flops" / f"{name}.py")


def test_gcn_flops():
    # layer 1: 3 -> 4, forward and dW: 2 * 2*5*3*4 = 240; aggregation 2 * 2*7*4 = 112
    # layer 2: 4 -> 2, forward, dW, dX: 3 * 2*5*4*2 = 240; aggregation 2 * 2*7*2 = 56
    assert flops("gcn").step_flops(GCN, SHAPES) == 240 + 112 + 240 + 56


def test_gat_flops():
    # layer 1: 3 -> 2 heads x 4: linear 2 * 2*5*3*8 = 480; scores 3*2*2*5*8 = 480; edges 3*2*7*8 = 336
    # layer 2: 8 -> 1 head x 2: linear 3 * 2*5*8*2 = 480; scores 3*2*2*5*2 = 120; edges 3*2*7*2 = 84
    assert flops("gat").step_flops(GAT, SHAPES) == 480 + 480 + 336 + 480 + 120 + 84


def test_sampled_layers_use_their_hops():
    # two hops, outermost first: (destinations, sources, edges)
    shapes = {**SHAPES, "hops": [(6, 18, 12), (2, 6, 4)]}
    # layer 1 over 18 rows: 2*2*18*3*8 + 3*2*2*18*8 + 3*2*12*8; layer 2 over 6 rows: 3*2*6*8*2 + 3*2*2*6*2 + 3*2*4*2
    want = 1728 + 1728 + 576 + 576 + 144 + 48
    assert flops("gat").step_flops(GAT, shapes) == want


def test_k1_bounds():
    b = flops("gcn").kernel_bounds(GCN, SHAPES)["K1"]
    assert len(b) == 4  # forward and transpose of each layer
    # row_ptr 6*4, col 7*4, w 7*4, out 5*4*4, x 5*4*4 bytes; 2*7*4 operations
    assert b[0] == bounds.Bound(bytes=24 + 28 + 28 + 80 + 80, operations=56)
    assert b[0].bound_s == pytest.approx(max(240 / bounds.H100_BYTES_PER_S, 56 / bounds.H100_F32_FLOPS))


def test_k3_bounds():
    b = flops("gat").kernel_bounds(GAT, SHAPES)["K3"]
    assert len(b) == 4
    # (2 heads, 4 features): row_ptr 24, col 28, w 7*2*4 = 56, out and x 5*8*4 = 160 each; dh adds w_index 7*4
    assert b[0] == bounds.Bound(bytes=24 + 28 + 56 + 160 + 160, operations=2 * 7 * 8)
    assert b[1].bytes == b[0].bytes + 28
