"""The port's mid-block GCNConv and EncoderGCN against gnn_tpu, with
transferred weights and dropout 0.

Forward: rtol=1e-4, atol=1e-5; parameter gradients: rtol=1e-4, atol=1e-5
(float32; BatchNorm divides by a batch deviation, which amplifies the
summation-order differences of the products before it). Running statistics
after a step: rtol=1e-5. The 5-epoch ``fit`` loss curve and the returned
running statistics: rtol=1e-4, as for the GCN in tests/test_torch_train.py.

One parameter of EncoderGCN has a gradient that is zero in exact arithmetic:
the bias of ``pre``'s last Linear shifts the first conv's ``lin(x)`` by a
constant per feature, which that conv's BatchNorm subtracts again. What
reaches it is rounding noise of about 1e-9, which Adam (update ~ g /
(|g| + 1e-8)) turns into steps of up to ``lr`` whose direction differs
between any two implementations, and the first conv's running *mean*
follows that bias. Losses, every other parameter and every other running
statistic do not depend on it. Under Adam the tests leave those two tensors
out (``NOISE``); under SGD, where noise stays noise, they hold them too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import nn as jnn
from gnn_tpu.graphs.datasets import load_dataset as jax_load_dataset
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.models import EncoderGCN as JaxEncoderGCN
from gnn_tpu.mp import GCNConv as JaxGCNConv
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu_torch import nn as tnn
from gnn_tpu_torch.graphs import load_dataset, stochastic_block_model
from gnn_tpu_torch.models import EncoderGCN
from gnn_tpu_torch.mp import GCNConv
from gnn_tpu_torch.train import Config, fit

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(4)
NOISE = ("pre.blocks.layers.3.bias", "convs.0.batch_norm.running_mean")


@pytest.fixture(scope="module")
def graph():
    jd = jax_sbm(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    td = stochastic_block_model(num_nodes=200, num_classes=4, feature_dim=12, seed=11)
    return jd, jd.to_adjacency(norm="sym", layout="csr"), td, td.to_adjacency(norm="sym")


def _transfer(jax_model, port_model, buffers=None):
    params = {k: np.asarray(v) for k, v in jnn.state_dict(jax_model).items()}
    return tnn.load_jax_state_dict(port_model, params, buffers)


def _state_pairs(state):
    leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(state)]
    return list(zip(leaves[0::2], leaves[1::2]))


def _port_pairs(model):
    return [
        (m.running_mean.numpy(), m.running_var.numpy())
        for m in model.modules() if isinstance(m, tnn.BatchNorm)
    ]


def _check_stateful(jax_model, state, port_model, graph, rng, mask=None):
    """Outputs, parameter gradients and the new running statistics of one
    training-mode forward."""
    jd, jadj, td, tadj = graph
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    out = port_model(td.x, tadj, mask=tm)
    ct = rng.normal(size=tuple(out.shape)).astype(np.float32)

    def jax_loss(m):
        y, new_state = m(jd.x, jadj, state, mask=jm)
        return jnp.sum(y * jnp.asarray(ct)), (y, new_state)

    (_, (j_out, new_state)), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_model)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **FWD)
    j_named = jnn.state_dict(j_grads)
    for name, p in port_model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_named[name]), err_msg=name, **GRAD)
    for (mean, var), (jmean, jvar) in zip(_port_pairs(port_model), _state_pairs(new_state)):
        np.testing.assert_allclose(mean, jmean, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(var, jvar, rtol=1e-5)
    return new_state


@pytest.mark.parametrize("masked", [False, True])
def test_gcnconv_mid_block_matches_jax(graph, rng, masked):
    j, state = jnn.make_with_state(JaxGCNConv)(12, 16, key=KEY, mid_block=True)
    t = _transfer(j, GCNConv(12, 16, mid_block=True))
    assert set(jnn.state_dict(j)) == {n for n, _ in t.named_parameters()}
    assert {n for n, _ in t.named_buffers()} == {"batch_norm.running_mean", "batch_norm.running_var"}
    mask = rng.random(200) < 0.8 if masked else None
    _check_stateful(j, state, t, graph, rng, mask)


def test_gcnconv_mid_block_builds_dropout_only_when_asked():
    assert GCNConv(4, 4, mid_block=True).dropout is None
    assert GCNConv(4, 4, mid_block=True, dropout=0.3).dropout.rate == 0.3
    plain = GCNConv(4, 4, dropout=0.3)
    assert plain.dropout is None and plain.batch_norm is None and not list(plain.buffers())


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_encoder_gcn_state_dict_names_match_jax(num_layers):
    j, _ = jnn.make_with_state(JaxEncoderGCN)(12, 4, key=KEY, num_layers=num_layers)
    t = EncoderGCN(12, 4, num_layers=num_layers)
    want = {k: tuple(v.shape) for k, v in jnn.state_dict(j).items()}
    assert want == {k: tuple(p.shape) for k, p in t.named_parameters()}
    buffers = set(t.state_dict()) - set(want)
    assert buffers == {
        f"convs.{i}.batch_norm.running_{s}" for i in range(num_layers) for s in ("mean", "var")
    }
    # dropout > 0 appends Dropout entries, which shifts the later indices
    jd, _ = jnn.make_with_state(JaxEncoderGCN)(12, 4, key=KEY, num_layers=num_layers, dropout=0.5)
    td = EncoderGCN(12, 4, num_layers=num_layers, dropout=0.5)
    assert set(jnn.state_dict(jd)) == {k for k, _ in td.named_parameters()}
    assert "pre.blocks.layers.4.weight" in dict(td.named_parameters())


@pytest.mark.parametrize("num_layers,masked", [(2, False), (3, False), (2, True)])
def test_encoder_gcn_matches_jax(graph, rng, num_layers, masked):
    j, state = jnn.make_with_state(JaxEncoderGCN)(12, 4, key=KEY, num_layers=num_layers)
    t = _transfer(j, EncoderGCN(12, 4, num_layers=num_layers))
    mask = rng.random(200) < 0.8 if masked else None
    state = _check_stateful(j, state, t, graph, rng, mask)
    # inference on the running statistics of that step
    jd, jadj, td, tadj = graph
    want, _ = jnn.inference_mode(j)(jd.x, jadj, state)
    before = _port_pairs(t)[0][0].copy()
    np.testing.assert_allclose(t.eval()(td.x, tadj).detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_array_equal(_port_pairs(t)[0][0], before)


def test_encoder_gcn_carries_jax_buffers(graph, rng):
    """Inference from a JAX State that is not the initial one."""
    jd, jadj, td, tadj = graph
    j, state = jnn.make_with_state(JaxEncoderGCN)(12, 4, key=KEY, num_layers=2)
    for _ in range(3):
        _, state = j(jd.x, jadj, state)
    t = _transfer(j, EncoderGCN(12, 4, num_layers=2), _state_pairs(state)).eval()
    want, _ = jnn.inference_mode(j)(jd.x, jadj, state)
    np.testing.assert_allclose(t(td.x, tadj).detach().numpy(), np.asarray(want), **FWD)


def test_encoder_gcn_dropout_paths(graph):
    """Dropout parity is by behaviour, not bits: training mode with dropout
    follows the generator, and eval() equals the dropout-free model."""
    _, _, td, tadj = graph
    t = EncoderGCN(12, 4, dropout=0.5, generator=torch.Generator().manual_seed(0))
    a = t(td.x, tadj, generator=torch.Generator().manual_seed(1))
    b = t(td.x, tadj, generator=torch.Generator().manual_seed(1))
    c = t(td.x, tadj, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    plain = EncoderGCN(12, 4, dropout=0.0)
    plain.load_state_dict(
        {k.replace("layers.4.", "layers.3."): v for k, v in t.state_dict().items()}
    )
    torch.testing.assert_close(t.eval()(td.x, tadj), plain.eval()(td.x, tadj))


def _cfg(**over):
    cfg = Config.from_dict(
        {
            "dataset": "sbm",
            "model": {"name": "encoder_gcn", "num_layers": 2, "dropout": 0.0},
            "optim": {"lr": 0.01},
            "train": {"epochs": 5, "eval_every": 1},
        }
    )
    return cfg.apply_overrides([f"{k}={v}" for k, v in over.items()])


def _fit_both(cfg):
    jdata, tdata = jax_load_dataset("sbm"), load_dataset("sbm")
    jmodel = JaxEncoderGCN(tdata.num_features, 4, key=jax.random.PRNGKey(2), num_layers=2)
    tmodel = _transfer(jmodel, EncoderGCN(tdata.num_features, 4, num_layers=2))
    jout = jax_fit(JaxConfig.from_json(cfg.to_json()), jdata, model=jmodel, verbose=False)
    return jout, fit(cfg, tdata, model=tmodel, device="cpu", verbose=False)


def _check_buffers(tstate, jstate, skip=(), **tol):
    flat = [np.asarray(v) for v in jax.tree_util.tree_leaves(jstate)]
    assert len(flat) == len(tstate) == 4
    for (name, got), want in zip(tstate.items(), flat):
        if name not in skip:
            np.testing.assert_allclose(got.numpy(), want, err_msg=name, **tol)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_fit_encoder_gcn_losses_and_running_stats_match_jax(optimizer):
    cfg = _cfg(**{"optim.name": optimizer, "optim.lr": 0.01 if optimizer == "adam" else 0.05})
    (_, jstate, jhist), (tmodel, tstate, thist) = _fit_both(cfg)
    assert len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    assert thist[-1]["loss"] < thist[0]["loss"]
    for split in ("train_acc", "val_acc", "test_acc"):
        assert abs(thist[-1][split] - jhist[-1][split]) <= 0.01, split
    assert list(tstate) == [n for n, _ in tmodel.named_buffers()]
    _check_buffers(tstate, jstate, skip=NOISE if optimizer == "adam" else (), rtol=1e-4, atol=1e-6)
    assert not torch.equal(tstate["convs.0.batch_norm.running_var"], torch.ones(16))


def test_fit_early_stopping_restores_parameters_not_buffers_as_jax():
    """The JAX ``fit`` keeps the best epoch's parameters but returns the
    last epoch's buffer state; so does the port. The validation accuracy
    peaks early and the run stops ``patience`` evaluations later. Compared
    at rtol=1e-3 (more epochs, a larger lr)."""
    cfg = _cfg(**{"train.epochs": 40, "train.patience": 3, "optim.lr": 0.05})
    (jmodel, jstate, jhist), (tmodel, tstate, thist) = _fit_both(cfg)
    assert len(thist) == len(jhist) < 40
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-3)
    vals = [h["val_acc"] for h in thist]
    best_epoch = int(np.argmax(vals)) + 1  # the first maximum: later ties do not replace it
    assert best_epoch == len(thist) - 3
    jparams = jnn.state_dict(jmodel)
    for name, p in tmodel.named_parameters():
        if name not in NOISE:
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jparams[name]), rtol=1e-3, atol=1e-5, err_msg=name
            )
    _check_buffers(tstate, jstate, skip=NOISE, rtol=1e-3, atol=1e-5)
    # a run that ends at the best epoch has the same parameters and other buffers
    short = _cfg(**{"train.epochs": best_epoch, "optim.lr": 0.05})
    _, (smodel, sstate, _) = _fit_both(short)
    for (name, p), q in zip(tmodel.named_parameters(), smodel.parameters()):
        torch.testing.assert_close(p, q, msg=name)
    name = "convs.1.batch_norm.running_var"
    assert not torch.allclose(tstate[name], sstate[name], rtol=1e-3)


def test_encoder_gcn_reference_recipe_learns():
    """Port of tests/test_models.py::test_encoder_gcn_reference_recipe_learns:
    80 Adam steps at lr 0.01 on the 200-node SBM."""
    data = stochastic_block_model(num_nodes=200, num_classes=4, seed=4)
    cfg = _cfg(**{"train.epochs": 80, "train.eval_every": 80})
    model, state, hist = fit(cfg, data, device="cpu", verbose=False)
    assert isinstance(model, EncoderGCN) and state is not None
    assert hist[-1]["test_acc"] > 0.8, hist[-1]
