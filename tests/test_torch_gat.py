"""The port's GAT (``mp/gat.py``, ``models/gat.py``, ``fit``) against gnn_tpu.

Both packages see the same numpy inputs; the JAX module's weights are copied
into the port's by name. On the CPU the port's kernels take their plain
versions. The JAX layer takes its flash path on a ``layout="ell"``
adjacency and its non-flash path (softmax, then the weighted sum) on a
``layout="csr"`` one of fewer than 2048 edges; the port has one path, which
must match both. Forward and gradients: rtol=1e-4, atol=1e-5 (float32 terms
summed in another order, through an exp and a division).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jg
from gnn_tpu import nn as jnn
from gnn_tpu.graphs.datasets import load_dataset as jax_load_dataset
from gnn_tpu.models import GAT as JaxGAT
from gnn_tpu.mp import GATConv as JaxGATConv
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch import nn as tnn
from gnn_tpu_torch.graphs import Data, cora_like, load_dataset, stochastic_block_model
from gnn_tpu_torch.models import GAT
from gnn_tpu_torch.mp import GATConv
from gnn_tpu_torch.optim import Adam
from gnn_tpu_torch.train import Config, fit

TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(7)


def _transfer(jax_model, port_model):
    return tnn.load_jax_state_dict(
        port_model, {k: np.asarray(v) for k, v in jnn.state_dict(jax_model).items()}
    )


def _graph(rng, layout, n, e):
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64)
    ei, _ = tg.add_remaining_self_loops(ei, num_nodes=n)
    jadj = jg.build_adjacency(ei, num_nodes=n, layout=layout)
    assert (jadj.chunk_plan is not None) == (layout == "ell")
    return jadj, tg.build_adjacency(ei, num_nodes=n)


def _check(jax_model, port_model, jadj, tadj, x, rng):
    """Forward, input gradient and every parameter gradient."""
    n_out = port_model(torch.from_numpy(x), tadj).shape
    ct = rng.normal(size=n_out).astype(np.float32)

    def jax_loss(m, x):
        out = m(x, jadj)
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, j_out), (j_grads, j_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jax_model, jnp.asarray(x)
    )
    xt = torch.from_numpy(x).requires_grad_()
    out = port_model(xt, tadj)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **TOL)
    j_named = jnn.state_dict(j_grads)
    assert set(j_named) == {k for k, _ in port_model.named_parameters()}
    for name, p in port_model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_named[name]), err_msg=name, **TOL)


@pytest.mark.parametrize(
    "layout,e,concat,use_bias",
    [("ell", 3000, True, True), ("csr", 1500, True, True), ("ell", 3000, False, False)],
    ids=["ell-flash-concat", "csr-nonflash-concat", "ell-flash-mean-nobias"],
)
def test_gatconv_matches_jax(rng, layout, e, concat, use_bias):
    n = 250
    jadj, tadj = _graph(rng, layout, n, e)
    assert (jadj.num_edges >= 2048) == (layout == "ell")
    x = rng.normal(size=(n, 12)).astype(np.float32)
    j = JaxGATConv(12, 8, key=KEY, heads=3, concat=concat, use_bias=use_bias)
    t = _transfer(j, GATConv(12, 8, heads=3, concat=concat, use_bias=use_bias))
    _check(j, t, jadj, tadj, x, rng)


def test_gatconv_return_attention_matches_jax(rng):
    n = 200
    jadj, tadj = _graph(rng, "csr", n, 1200)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    j = JaxGATConv(6, 4, key=KEY, heads=2)
    t = _transfer(j, GATConv(6, 4, heads=2))
    j_out, j_alpha = j(jnp.asarray(x), jadj, return_attention=True)
    out, alpha = t(torch.from_numpy(x), tadj, return_attention=True)
    assert alpha.shape == (tadj.num_edges, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(j_alpha), **TOL)


def _toy(rng, n=12, e=40, f=6):
    """tests/test_mp.py's toy graph: coalesced random edges, N(0,1) features."""
    ei, _ = tg.coalesce(np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), num_nodes=n)
    return Data(x=rng.normal(size=(n, f)).astype(np.float32), edge_index=ei, num_nodes=n)


def test_gatconv_attention_normalized(rng):
    """Port of tests/test_mp.py::test_gatconv_attention_normalized."""
    data = _toy(rng)
    adj = data.to_adjacency(norm=None, add_self_loops=True)
    out, alpha = GATConv(6, 4, heads=3)(data.x, adj, return_attention=True)
    assert out.shape == (12, 12)
    sums = np.zeros((12, 3))
    np.add.at(sums, adj.dst.numpy(), alpha.detach().numpy())
    np.testing.assert_allclose(sums, 1.0, rtol=1e-4)


def test_gatconv_single_head_golden(rng):
    """Port of tests/test_mp.py::test_gatconv_single_head_golden: 1 head
    against dense masked-softmax attention."""
    data = _toy(rng, n=8, e=20)
    adj = data.to_adjacency(norm=None, add_self_loops=True)
    conv = GATConv(6, 4, heads=1, use_bias=False, generator=torch.Generator().manual_seed(0))
    got = conv(data.x, adj).detach().numpy()
    h = conv.lin(data.x).detach().numpy()
    a_src = conv.att_src.detach().numpy()[0]
    a_dst = conv.att_dst.detach().numpy()[0]
    mask = np.zeros((8, 8), bool)
    mask[adj.dst.numpy(), adj.src.numpy()] = True
    scores = (h @ a_dst)[:, None] + (h @ a_src)[None, :]  # [dst, src]
    scores = np.where(scores > 0, scores, 0.2 * scores)
    scores = np.where(mask, scores, -np.inf)
    scores = scores - scores.max(1, keepdims=True)
    att = np.exp(scores) / np.maximum(np.exp(scores).sum(1, keepdims=True), 1e-16)
    want = np.where(mask, att, 0.0) @ h
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_gatconv_wide_segment_scales(rng):
    """Port of tests/test_mp.py::test_gatconv_fused_wide_segment_scales:
    per-segment score scales spanning hundreds of units need the
    per-segment max shift. The JAX package's non-flash path (a per-segment
    softmax) is the oracle."""
    n, e = 24, 90
    ei, _ = tg.coalesce(np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), num_nodes=n)
    ei, _ = tg.add_remaining_self_loops(ei, num_nodes=n)
    scale = np.where(np.arange(n) % 2 == 0, 60.0, 0.05).astype(np.float32)
    x = rng.normal(size=(n, 6)).astype(np.float32) * scale[:, None]
    j = JaxGATConv(6, 4, key=KEY, heads=2, use_bias=False)
    t = _transfer(j, GATConv(6, 4, heads=2, use_bias=False))
    want = np.asarray(j(jnp.asarray(x), jg.build_adjacency(ei, num_nodes=n, layout="csr")))
    got = t(torch.from_numpy(x), tg.build_adjacency(ei, num_nodes=n)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (np.linalg.norm(got, axis=1) > 0.5 * np.linalg.norm(want, axis=1)).all()


def test_gat_bf16_messages_close_to_f32(rng):
    """Port of tests/test_mp.py::test_gat_bf16_messages_close_to_f32:
    message_dtype=bfloat16 stays within 0.03 x scale of float32, and its
    gradients are finite."""
    n, e = 300, 4000
    ei, _ = tg.to_undirected(np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), num_nodes=n)
    adj = tg.build_adjacency(ei, num_nodes=n)
    x = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
    conv32 = GATConv(32, 8, heads=4, generator=torch.Generator().manual_seed(3))
    convbf = GATConv(32, 8, heads=4, message_dtype=torch.bfloat16)
    convbf.load_state_dict(conv32.state_dict())
    o32 = conv32(x, adj).detach().numpy()
    obf = convbf(x, adj)
    assert obf.dtype == torch.float32
    scale = np.abs(o32).max()
    assert np.abs(obf.detach().numpy() - o32).max() < 0.03 * scale
    xr = x.clone().requires_grad_()
    (convbf(xr, adj) ** 2).sum().backward()
    assert torch.isfinite(xr.grad).all()
    assert all(torch.isfinite(p.grad).all() for p in convbf.parameters())


def test_gatconv_dropout_drops_only_numerator_weights(rng):
    """Training mode, dropout 0.5: the mask (rebuilt from the same seeded
    generator) scales the numerator's weights ex only; the denominator sums
    the undropped ex. A numpy oracle in float64."""
    n, H, F, rate = 80, 2, 4, 0.5
    ei = np.stack([rng.integers(0, n, 700), rng.integers(0, n, 700)])
    ei, _ = tg.add_remaining_self_loops(ei, num_nodes=n)
    adj = tg.build_adjacency(ei, num_nodes=n)
    E = adj.num_edges
    conv = GATConv(6, F, heads=H, dropout=rate, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(1))
    x = rng.normal(size=(n, 6)).astype(np.float32)
    got = conv.train()(torch.from_numpy(x), adj, generator=torch.Generator().manual_seed(5))
    keep = (torch.rand((E, H), generator=torch.Generator().manual_seed(5)) < 1 - rate).numpy()

    p = {k: v.detach().double().numpy() for k, v in conv.state_dict().items()}
    src, dst = adj.src.numpy(), adj.dst.numpy()
    h = (x.astype(np.float64) @ p["lin.weight"].T).reshape(n, H, F)
    s = (h * p["att_dst"]).sum(-1)[dst] + (h * p["att_src"]).sum(-1)[src]
    s = np.where(s > 0, s, 0.2 * s)
    m = np.full((n, H), -np.inf)
    np.maximum.at(m, dst, s)
    ex = np.exp(s - m[dst])
    den = np.zeros((n, H))
    np.add.at(den, dst, ex)
    num = np.zeros((n, H, F))
    np.add.at(num, dst, (ex * keep / (1 - rate))[:, :, None] * h[src])
    want = (num / np.maximum(den, 1e-16)[:, :, None]).reshape(n, H * F) + p["bias"]
    assert 0.3 < keep.mean() < 0.7
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    # inference mode drops nothing and draws no random numbers
    gen = torch.Generator().manual_seed(5)
    conv.eval()(torch.from_numpy(x), adj, generator=gen)
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(5).get_state())


@pytest.mark.parametrize("num_layers", [2, 3])
def test_gat_matches_jax(rng, num_layers):
    jd = jg.generate.stochastic_block_model(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    td = stochastic_block_model(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    j = JaxGAT(12, 8, 4, key=KEY, num_layers=num_layers, heads=3, dropout=0.0)
    t = _transfer(j, GAT(12, 8, 4, num_layers=num_layers, heads=3, dropout=0.0))
    assert {k: tuple(v.shape) for k, v in jnn.state_dict(j).items()} == {
        k: tuple(v.shape) for k, v in t.state_dict().items()
    }
    _check(j, t, jd.to_adjacency(norm="sym", layout="csr"), td.to_adjacency(norm="sym"),
           td.x.numpy(), rng)


def test_gat_unported_forms_raise():
    t = GAT(4, 4, 2, heads=2)
    # forward_sampled is ported: without one adjacency per conv it raises
    # the JAX package's error (gnn_tpu/models/gat.py:86-87)
    with pytest.raises(ValueError, match="need 2 hop adjacencies"):
        t.forward_sampled(torch.zeros(3, 4), [])
    # the partitioned forward is ported (tests/test_torch_dist_models.py);
    # attention weights stay single-device, as in the JAX package
    from gnn_tpu_torch.parallel import make_mesh, partition_graph

    mesh = make_mesh(axes=("data",), devices=[torch.device("cpu")] * 2)
    dist = partition_graph(np.array([[0, 1, 2], [1, 2, 0]]), num_nodes=3, num_parts=2, mesh=mesh)
    with pytest.raises(ValueError, match="single-device"):
        t.convs[0](torch.zeros(2 * dist.n_max, 4), dist, return_attention=True)


def _cfg(**over):
    cfg = Config.from_dict(
        {
            "dataset": "sbm",
            "model": {"name": "gat", "hidden": 8, "heads": 4, "dropout": 0.0},
            "optim": {"lr": 0.005},
            "train": {"epochs": 5, "eval_every": 1},
        }
    )
    return cfg.apply_overrides([f"{k}={v}" for k, v in over.items()])


def test_fit_gat_losses_match_jax():
    """fit with model.name='gat': the 5-epoch loss curve of
    gnn_tpu.train.fit at rtol=1e-4, dropout 0, the same initial weights."""
    jdata, tdata = jax_load_dataset("sbm"), load_dataset("sbm")
    jmodel = JaxGAT(tdata.num_features, 8, 4, key=jax.random.PRNGKey(2), heads=4, dropout=0.0)
    tmodel = _transfer(jmodel, GAT(tdata.num_features, 8, 4, heads=4, dropout=0.0))
    _, _, jhist = jax_fit(JaxConfig.from_json(_cfg().to_json()), jdata, model=jmodel, verbose=False)
    _, state, thist = fit(_cfg(), tdata, model=tmodel, device="cpu", verbose=False)
    assert state is None and len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    for split in ("train_acc", "val_acc", "test_acc"):
        assert abs(thist[-1][split] - jhist[-1][split]) <= 0.01, split


def test_fit_builds_gat_from_config():
    model, _, hist = fit(_cfg(**{"train.epochs": 2}), load_dataset("karate"), device="cpu", verbose=False)
    assert isinstance(model, GAT) and len(model.convs) == 2
    assert (model.convs[0].heads, model.convs[0].out_features, model.convs[1].heads) == (4, 8, 1)
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_gat_learns_sbm():
    """Port of tests/test_models.py::test_gat_learns_sbm."""
    data = stochastic_block_model(num_nodes=150, num_classes=3, seed=3)
    adj = data.to_adjacency(norm="sym")
    model = GAT(16, 8, 3, heads=4, dropout=0.2, generator=torch.Generator().manual_seed(0))
    opt = Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator().manual_seed(1)
    for _ in range(100):
        opt.zero_grad()
        tnn.cross_entropy(model(data.x, adj, generator=gen), data.y, data.train_mask).backward()
        opt.step()
    model.eval()
    acc = tnn.accuracy(model(data.x, adj), data.y, data.test_mask).item()
    assert acc > 0.8, f"GAT test accuracy {acc}"


def test_cora_like_gat_accuracy_band():
    """The GAT Cora recipe (8 heads x 8, dropout 0.6, Adam lr 0.005, weight
    decay 5e-4, 200 epochs) through the port's fit. gnn_tpu.train.fit reaches
    0.823 test accuracy with the same recipe and seed on the CPU (0.827 and
    0.821 with train.seed 1 and 2); the band is that value +- 0.05."""
    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.heads, cfg.model.dropout = "gat", 8, 8, 0.6
    cfg.optim.lr, cfg.optim.weight_decay = 0.005, 5e-4
    cfg.train.epochs, cfg.train.eval_every = 200, 200
    _, _, hist = fit(cfg, cora_like(seed=0), device="cpu", verbose=False)
    acc = hist[-1]["test_acc"]
    assert 0.773 <= acc <= 0.873, f"outside the band of gnn_tpu.train.fit: {acc}"
