"""The port's GATv2 (``ops/cuda/gatv2_score.py``, ``mp/gatv2.py``,
``models/gat.py::GATv2``, ``fit``) against the plain float64 reference of the
benchmark (``gnnbench/reference/gatv2.py``: plain torch, no kernel of the
port), on seeded random weights at a small size on the CPU, where the score
op takes its plain versions.

The dropout keep masks the port draws are read back through
``utils.tracing.watch`` and fed to the reference. Tolerances: the port sums
float32 terms where the reference sums float64 ones, through an exp and a
division, over rows of at most a few hundred edges: rtol=1e-4, atol=1e-5 on
outputs and gradients; the op alone against its float64 expression
rtol=atol=1e-5 (one float32 dot product of F terms a score).
"""

import numpy as np
import pytest
import torch

from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch.graphs import load_dataset
from gnn_tpu_torch.models import GATv2
from gnn_tpu_torch.mp import GATv2Conv
from gnn_tpu_torch.ops.cuda.gatv2_score import gatv2_score_edges
from gnn_tpu_torch.train import Config, build_model, fit
from gnn_tpu_torch.utils.tracing import watch
from gnnbench.reference import common
from gnnbench.reference import gatv2 as ref

TOL = dict(rtol=1e-4, atol=1e-5)
HEADS = [(8, 8), (1, 40), (3, 5)]


def _graph(n=120, e=600, seed=0, hub=True, self_loops=True):
    """A random graph; with ``hub`` node 0 receives an edge from every
    other node, and the nodes n - 10 .. n - 1 receive none (without self
    loops: empty rows)."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 10, e)
    if hub:
        src, dst = np.concatenate([src, np.arange(1, n)]), np.concatenate([dst, np.zeros(n - 1, np.int64)])
    ei = tg.coalesce(np.stack([src, dst]).astype(np.int64), num_nodes=n)[0]
    if self_loops:
        ei, _ = tg.add_remaining_self_loops(ei, num_nodes=n)
    return tg.build_adjacency(ei, num_nodes=n)


def _dropout_masks():
    """A list that collects every keep mask the port draws, and its watch."""
    masks = []
    return masks, watch(lambda kind, **p: masks.append(p["mask"]) if kind == "dropout" else None)


def test_score_op_against_float64_and_gradcheck():
    """The op on a graph with empty rows and a hub: forward against the
    float64 expression at (3, 5), and its backward (the plain rule the
    kernel follows) by ``gradcheck`` in float64."""
    adj = _graph(n=40, e=120, self_loops=False)
    assert int((adj.row_ptr[1:] == adj.row_ptr[:-1]).sum()) >= 10
    g = torch.Generator().manual_seed(0)
    h_src, h_dst, att = (torch.randn(s, generator=g, dtype=torch.float64) for s in ((40, 3, 5), (40, 3, 5), (3, 5)))
    want = (torch.nn.functional.leaky_relu(h_dst[adj.dst.long()] + h_src[adj.src.long()], 0.2) * att).sum(-1)
    got = gatv2_score_edges(adj, h_src.float(), h_dst.float(), att.float())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    args = tuple(t.clone().requires_grad_() for t in (h_src, h_dst, att))
    assert torch.autograd.gradcheck(lambda s, d, a: gatv2_score_edges(adj, s, d, a), args)


def _params(module, prefix=""):
    return {prefix + k: v.detach().double().requires_grad_() for k, v in module.named_parameters()}


def _check_grads(port_params, port_out, ref_params, ref_out, ct):
    torch.testing.assert_close(port_out.double(), ref_out.detach(), **TOL)
    (port_out * ct.float()).sum().backward()
    (ref_out * ct).sum().backward()
    for name, p in port_params:
        torch.testing.assert_close(p.grad.double(), ref_params[name].grad, msg=name, **TOL)


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("heads,feats", HEADS)
def test_conv_against_the_reference(heads, feats, concat):
    """One layer in training mode (attention dropout 0.3): forward and every
    parameter's gradient against the reference's layer with the same mask."""
    adj = _graph()
    n, d_in = adj.num_dst_nodes, 12
    conv = GATv2Conv(d_in, feats, heads=heads, concat=concat, dropout=0.3,
                     generator=torch.Generator().manual_seed(heads * feats))
    with torch.no_grad():
        conv.bias.uniform_(-0.5, 0.5)
    x = torch.randn(n, d_in, generator=torch.Generator().manual_seed(1))
    masks, watching = _dropout_masks()
    with watching:
        out = conv(x, adj, generator=torch.Generator().manual_seed(2))
    assert len(masks) == 1 and masks[0].shape == (adj.num_edges, heads)
    params = _params(conv, "convs.0.")
    want = ref.conv(params, 0, (d_in, heads, feats, concat), x.double(), adj.src.long(), adj.dst.long(), n,
                    masks[0], 0.3, common.REFERENCE)
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    _check_grads([("convs.0." + k, p) for k, p in conv.named_parameters()], out, params, want, ct)


@pytest.mark.parametrize("heads,feats", HEADS)
def test_model_against_the_reference(heads, feats):
    """The two-layer model in training mode (input and attention dropout
    0.6), ``feats`` features a head in the hidden layer: logits and every
    parameter's gradient of the masked cross entropy."""
    adj = _graph(seed=4)
    n, d_in, classes = adj.num_dst_nodes, 16, 5
    model = GATv2(d_in, feats, classes, heads=heads, dropout=0.6, generator=torch.Generator().manual_seed(5))
    x = torch.randn(n, d_in, generator=torch.Generator().manual_seed(6))
    y = torch.randint(0, classes, (n,), generator=torch.Generator().manual_seed(7))
    masks, watching = _dropout_masks()
    with watching:
        logits = model(x, adj, generator=torch.Generator().manual_seed(8))
    assert [m.shape[0] for m in masks] == [n, adj.num_edges] * 2
    params = _params(model)
    cfg = {"num_layers": 2, "heads": heads, "hidden": feats, "dropout": 0.6}
    graph = {"edge_index": torch.stack([adj.src.long(), adj.dst.long()])}
    want = ref.logits(params, cfg, graph, x.double(), masks, common.REFERENCE)
    torch.testing.assert_close(logits.double(), want.detach(), **TOL)
    common.cross_entropy(logits, y).backward()
    common.cross_entropy(want, y).backward()
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad.double(), params[name].grad, msg=name, **TOL)


def test_parameter_names_and_shapes_are_the_references():
    model = GATv2(128, 8, 40, heads=8)
    cfg = {"num_layers": 2, "heads": 8, "hidden": 8, "dropout": 0.6}
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == ref.param_shapes(cfg, 128, 40)


def _cfg(**overrides):
    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.heads, cfg.model.dropout = "gatv2", 8, 2, 0.3
    cfg.optim.lr, cfg.train.epochs, cfg.train.eval_every = 0.01, 10, 1
    return cfg.apply_overrides([f"{k}={v}" for k, v in overrides.items()])


def test_fit_trains_gatv2_on_its_normal_path():
    """``fit`` builds the model from ``model.name`` (through ``build_model``,
    on the relabelled CSR of ``train.reorder='auto'``) and its loss falls."""
    model, state, hist = fit(_cfg(), load_dataset("sbm"), device="cpu", verbose=False)
    assert isinstance(model, GATv2) and state is None and len(hist) == 10
    assert all(np.isfinite(h["loss"]) for h in hist) and hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.parametrize("override", [{"train.batch_size": 64}, {"dist.num_parts": 2}])
def test_unsupported_paths_raise(override):
    """Sampled minibatches (no ``forward_sampled``) and the partitioned
    ``DistGraph`` are refused with an error that names them."""
    match = "forward_sampled" if "train.batch_size" in override else "DistGraph"
    with pytest.raises(ValueError, match=match):
        fit(_cfg(**override), load_dataset("karate"), device="cpu", verbose=False)
    assert isinstance(build_model(_cfg(), 4, 2), GATv2)
