"""The port's layers and GCN against gnn_tpu with transferred weights.

Both packages see the same graph and numpy inputs; the JAX model's weights
are copied into the port model by name. Forward: rtol=1e-5, atol=1e-6 (same
float32 terms, another summation order). Parameter gradients: rtol=1e-4,
atol=1e-5 (two chained products and a reduction over all nodes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import nn as jnn
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.models import GCN as JaxGCN
from gnn_tpu.mp import GCNConv as JaxGCNConv
from gnn_tpu_torch import nn as tnn
from gnn_tpu_torch.graphs import stochastic_block_model
from gnn_tpu_torch.models import GCN
from gnn_tpu_torch.mp import GCNConv

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def graph():
    jd = jax_sbm(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    td = stochastic_block_model(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    return jd, jd.to_adjacency(norm="sym", layout="csr"), td, td.to_adjacency(norm="sym")


def _transfer(jax_model, port_model):
    return tnn.load_jax_state_dict(
        port_model, {k: np.asarray(v) for k, v in jnn.state_dict(jax_model).items()}
    )


def _check_forward_and_grads(jax_model, port_model, graph, rng):
    jd, jadj, td, tadj = graph
    ct = rng.normal(size=(td.num_nodes, port_model(td.x, tadj).shape[1])).astype(np.float32)

    def jax_loss(m):
        out = m(jd.x, jadj)
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_model)
    out = port_model(td.x, tadj)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **FWD)
    j_named = jnn.state_dict(j_grads)
    for name, p in port_model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_named[name]), err_msg=name, **GRAD)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_gcn_state_dict_keys_match(num_layers):
    j = JaxGCN(12, 32, 4, key=jax.random.PRNGKey(0), num_layers=num_layers)
    t = GCN(12, 32, 4, num_layers=num_layers)
    assert set(jnn.state_dict(j)) == set(t.state_dict())
    assert {k: tuple(v.shape) for k, v in jnn.state_dict(j).items()} == {
        k: tuple(v.shape) for k, v in t.state_dict().items()
    }


def test_load_jax_state_dict_rejects_missing_and_mismatched():
    t = GCN(12, 32, 4)
    good = {k: v.numpy() for k, v in t.state_dict().items()}
    missing = dict(good)
    missing.pop("convs.1.bias")
    with pytest.raises(KeyError, match="convs.1.bias"):
        tnn.load_jax_state_dict(t, missing)
    bad = dict(good, **{"convs.0.lin.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tnn.load_jax_state_dict(t, bad)


@pytest.mark.parametrize("use_bias", [True, False])
def test_gcnconv_matches_jax(graph, rng, use_bias):
    j = JaxGCNConv(12, 16, key=jax.random.PRNGKey(3), use_bias=use_bias)
    t = _transfer(j, GCNConv(12, 16, use_bias=use_bias))
    _check_forward_and_grads(j, t, graph, rng)


@pytest.mark.parametrize("num_layers,hidden", [(2, 16), (3, 32)])
def test_gcn_matches_jax(graph, rng, num_layers, hidden):
    j = JaxGCN(12, hidden, 4, key=jax.random.PRNGKey(5), num_layers=num_layers, dropout=0.0)
    t = _transfer(j, GCN(12, hidden, 4, num_layers=num_layers, dropout=0.0))
    _check_forward_and_grads(j, t, graph, rng)


def test_gcn_inference_mode_matches_jax_with_dropout(graph):
    """Dropout > 0 in inference mode is the identity in both packages."""
    jd, jadj, td, tadj = graph
    j = JaxGCN(12, 16, 4, key=jax.random.PRNGKey(6), dropout=0.5)
    t = _transfer(j, GCN(12, 16, 4, dropout=0.5)).eval()
    want = jnn.inference_mode(j)(jd.x, jadj)
    np.testing.assert_allclose(t(td.x, tadj).detach().numpy(), np.asarray(want), **FWD)


def test_dropout_keeps_expected_fraction():
    x = torch.ones(200, 500)
    d = tnn.Dropout(0.3)
    y = d(x, generator=torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))
    assert d.eval()(x) is x


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_accuracy_match(rng, masked):
    from gnn_tpu.nn import accuracy as jax_accuracy
    from gnn_tpu.nn import cross_entropy as jax_cross_entropy

    logits = rng.normal(size=(64, 7)).astype(np.float32) * 3
    y = rng.integers(0, 7, 64)
    mask = rng.random(64) < 0.4 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for smoothing in (0.0, 0.1):
        np.testing.assert_allclose(
            tnn.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y), tm,
                              label_smoothing=smoothing).item(),
            float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(y), jm,
                                    label_smoothing=smoothing)),
            rtol=1e-6,
        )
    np.testing.assert_allclose(
        tnn.accuracy(torch.from_numpy(logits), torch.from_numpy(y), tm).item(),
        float(jax_accuracy(jnp.asarray(logits), jnp.asarray(y), jm)),
        rtol=1e-6,
    )
    empty = np.zeros(64, bool)
    assert tnn.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                             torch.from_numpy(empty)).item() == 0.0
