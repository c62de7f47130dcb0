"""The port's ``nn`` layers against gnn_tpu.nn on the same numpy inputs.

Activations, normalizations and losses: rtol=1e-6 (the same float32
elementwise arithmetic; atol=1e-6 where a result passes through zero). MLP
forward: rtol=1e-5, atol=1e-6 (matmul sums in another order). BatchNorm's
running statistics after three steps: rtol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import nn as jnn
from gnn_tpu_torch import nn as tnn

ELEMENTWISE = dict(rtol=1e-6, atol=1e-6)
KEY = jax.random.PRNGKey(0)


def _np(t):
    return t.detach().numpy()


def _jax_params(jax_model):
    return {k: np.asarray(v) for k, v in jnn.state_dict(jax_model).items()}


@pytest.mark.parametrize(
    "name", ["relu", "leaky_relu", "gelu", "elu", "sigmoid", "tanh", "softmax", "log_softmax"]
)
def test_activation_functions_match_jax(rng, name):
    x = (rng.normal(size=(33, 7)) * 3).astype(np.float32)
    got = getattr(tnn, name)(torch.from_numpy(x))
    want = getattr(jnn, name)(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **ELEMENTWISE)


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("ReLU", {}),
        ("LeakyReLU", {"negative_slope": 0.2}),
        ("GELU", {}),
        ("ELU", {}),
        ("Sigmoid", {}),
        ("Tanh", {}),
        ("Softmax", {"axis": 0}),
        ("LogSoftmax", {"axis": 0}),
    ],
)
def test_activation_modules_match_jax(rng, name, kwargs):
    x = (rng.normal(size=(33, 7)) * 3).astype(np.float32)
    got = getattr(tnn, name)(**kwargs)(torch.from_numpy(x))
    want = getattr(jnn, name)(**kwargs)(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **ELEMENTWISE)
    assert not list(getattr(tnn, name)(**kwargs).parameters())


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-3, 3, 61)
    torch.testing.assert_close(tnn.gelu(x), torch.nn.functional.gelu(x, approximate="tanh"))
    assert (tnn.gelu(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4


@pytest.mark.parametrize("affine", [True, False])
def test_layernorm_matches_jax(rng, affine):
    x = (rng.normal(size=(19, 12)) * 2 + 1).astype(np.float32)
    j = jnn.LayerNorm(12, elementwise_affine=affine)
    t = tnn.LayerNorm(12, elementwise_affine=affine)
    if affine:
        w, b = rng.normal(size=12).astype(np.float32), rng.normal(size=12).astype(np.float32)
        j = j.replace(weight=jnp.asarray(w), bias=jnp.asarray(b))
        tnn.load_jax_state_dict(t, {"weight": w, "bias": b})
    np.testing.assert_allclose(_np(t(torch.from_numpy(x))), np.asarray(j(jnp.asarray(x))), **ELEMENTWISE)


def test_layernorm_statistics_and_bf16():
    """Port of tests/test_layers.py's LayerNorm check; float32 statistics
    for a bfloat16 input, output in the input's dtype."""
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0], [5.0, 5.0, 5.0, 5.0]])
    y = tnn.LayerNorm(4)(x)
    np.testing.assert_allclose(_np(y).mean(-1), 0.0, atol=1e-6)
    np.testing.assert_allclose(_np(y)[0].std(), 1.0, atol=1e-2)
    np.testing.assert_allclose(_np(y)[1], 0.0, atol=1e-3)
    y16 = tnn.LayerNorm(4)(x.bfloat16())
    assert y16.dtype == torch.bfloat16
    torch.testing.assert_close(y16.float(), y, rtol=2e-2, atol=2e-2)


def test_layernorm_with_bf16_parameters():
    """``dtype=`` sets the affine parameters' dtype, as in the JAX layer; the
    statistics stay float32 and the output follows the input."""
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0], [5.0, 5.0, 5.0, 5.0]])
    ln = tnn.LayerNorm(4, dtype=torch.bfloat16)
    assert ln.weight.dtype == torch.bfloat16
    y16 = ln(x.bfloat16())
    assert y16.dtype == torch.bfloat16
    torch.testing.assert_close(y16.float(), tnn.LayerNorm(4)(x), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(ln(x), tnn.LayerNorm(4)(x))  # weight 1, bias 0 are exact in bf16


def test_batchnorm_train_eval_split():
    """Port of tests/test_layers.py::test_batchnorm_train_eval_split."""
    bn = tnn.BatchNorm(2, momentum=0.5)
    x = torch.tensor([[1.0, 10.0], [3.0, 30.0]])
    y = bn(x)
    np.testing.assert_allclose(_np(y).mean(0), 0.0, atol=1e-5)
    # running = 0.5 * old + 0.5 * new, with the unbiased variance
    np.testing.assert_allclose(_np(bn.running_mean), [1.0, 10.0], atol=1e-5)
    np.testing.assert_allclose(_np(bn.running_var), 0.5 + 0.5 * np.array([2.0, 200.0]), rtol=1e-5)
    bn.eval()
    before = bn.running_mean.clone()
    y_eval = bn(x)
    want = (x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
    torch.testing.assert_close(y_eval, want)
    torch.testing.assert_close(bn.running_mean, before)  # eval leaves the buffers alone


def test_batchnorm_masked_stats_match_unpadded(rng):
    """Port of tests/test_layers.py::test_batchnorm_masked_stats_match_unpadded."""
    x_real = torch.from_numpy(rng.normal(size=(12, 4)).astype(np.float32))
    x_pad = torch.cat([x_real, torch.full((4, 4), 7.5)])
    mask = torch.cat([torch.ones(12, dtype=torch.bool), torch.zeros(4, dtype=torch.bool)])
    ref, masked = tnn.BatchNorm(4, momentum=0.3), tnn.BatchNorm(4, momentum=0.3)
    y_ref, y_mask = ref(x_real), masked(x_pad, mask=mask)
    np.testing.assert_allclose(_np(y_mask)[:12], _np(y_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(masked.running_mean), _np(ref.running_mean), rtol=1e-5)
    np.testing.assert_allclose(_np(masked.running_var), _np(ref.running_var), rtol=1e-5)
    with pytest.raises(ValueError, match="mask shape"):
        masked(x_pad, mask=mask[:3])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_matches_jax_over_three_steps(rng, masked, affine):
    """Outputs, input gradients and the running statistics of three
    training steps, then the inference output."""
    j = jnn.BatchNorm(6, momentum=0.2, affine=affine)
    t = tnn.BatchNorm(6, momentum=0.2, affine=affine)
    state = jnn.init_state(j)
    for step in range(3):
        x = (rng.normal(size=(40, 6)) * (step + 1) + step).astype(np.float32)
        ct = rng.normal(size=(40, 6)).astype(np.float32)
        mask = rng.random(40) < 0.7 if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.from_numpy(mask)

        def loss(xj):
            y, new_state = j(xj, state, mask=jm)
            return jnp.sum(y * ct), (y, new_state)

        (_, (jy, state)), jdx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        ty = t(tx, mask=tm)
        (ty * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(tx.grad), np.asarray(jdx), rtol=1e-4, atol=1e-5)
    mean, var = state.get(j.stats)
    np.testing.assert_allclose(_np(t.running_mean), np.asarray(mean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(t.running_var), np.asarray(var), rtol=1e-6)
    assert not t.running_mean.requires_grad and t.running_mean.dtype == torch.float32
    x = rng.normal(size=(9, 6)).astype(np.float32)
    jy, _ = jnn.inference_mode(j)(jnp.asarray(x), state)
    np.testing.assert_allclose(_np(t.eval()(torch.from_numpy(x))), np.asarray(jy), rtol=1e-5, atol=1e-6)


def test_batchnorm_bf16_and_leading_axes(rng):
    """Statistics over all leading axes, in float32 whatever x's dtype."""
    x = torch.from_numpy(rng.normal(size=(3, 10, 4)).astype(np.float32))
    bn3, bn2 = tnn.BatchNorm(4), tnn.BatchNorm(4)
    torch.testing.assert_close(bn3(x).view(-1, 4), bn2(x.view(-1, 4)))
    torch.testing.assert_close(bn3.running_var, bn2.running_var)
    bn16 = tnn.BatchNorm(4)
    y16 = bn16(x.bfloat16())
    assert y16.dtype == torch.bfloat16 and bn16.running_mean.dtype == torch.float32
    torch.testing.assert_close(bn16.running_var, bn2.running_var, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize(
    "hidden,dropout,use_norm",
    [([24, 12], 0.0, True), ([24, 12], 0.3, True), ([24, 12, 5], 0.0, False), ([5], 0.5, True)],
)
def test_mlp_state_dict_keys_and_forward_match_jax(rng, hidden, dropout, use_norm):
    """The layer index in the names counts LayerNorm, ReLU and Dropout too."""
    j = jnn.MLP(12, hidden, key=KEY, dropout=dropout, use_norm=use_norm)
    t = tnn.MLP(12, hidden, dropout=dropout, use_norm=use_norm)
    jsd = jnn.state_dict(j)
    assert {k: tuple(v.shape) for k, v in jsd.items()} == {k: tuple(v.shape) for k, v in t.state_dict().items()}
    assert all(k.startswith("blocks.layers.") for k in jsd)
    assert len(t.blocks) == len(j.blocks)
    tnn.load_jax_state_dict(t, _jax_params(j))
    x = rng.normal(size=(30, 12)).astype(np.float32)
    want = jnn.inference_mode(j)(jnp.asarray(x))
    np.testing.assert_allclose(_np(t.eval()(torch.from_numpy(x))), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sequential_passes_the_generator_only_where_taken():
    # seeded weights and varied positive rows: with the process-wide generator's
    # weights and constant rows, ReLU zeroes every output once in 16 runs
    linear = tnn.Linear(4, 4, generator=torch.Generator().manual_seed(0))
    seq = tnn.Sequential([linear, tnn.ReLU(), tnn.Dropout(0.5), tnn.Identity()])
    assert set(seq.state_dict()) == {"layers.0.weight", "layers.0.bias"}
    assert len(seq) == 4 and isinstance(seq[2], tnn.Dropout)
    x = torch.rand(64, 4, generator=torch.Generator().manual_seed(3)) + 0.5
    a = seq(x, generator=torch.Generator().manual_seed(1))
    b = seq(x, generator=torch.Generator().manual_seed(1))
    c = seq(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(seq.eval()(x), seq[1](seq[0](x)))
    assert tnn.call_layer(tnn.ReLU(), -x, generator=torch.Generator()).sum() == 0


def test_mlp_dropout_statistics():
    """Dropout parity is by statistics: about ``rate`` of the hidden units
    are zeroed in training mode on top of ReLU's, none in inference."""
    mlp = tnn.MLP(8, [512, 4], dropout=0.5, use_norm=False, generator=torch.Generator().manual_seed(0))
    x = torch.randn(256, 8, generator=torch.Generator().manual_seed(1))
    hidden = lambda: mlp.blocks[2](mlp.blocks[1](mlp.blocks[0](x)), generator=torch.Generator().manual_seed(3))
    dropped = (hidden() == 0).float().mean().item()
    relu_only = (mlp.blocks[1](mlp.blocks[0](x)) == 0).float().mean().item()
    assert abs(dropped - (relu_only + 0.5 * (1 - relu_only))) < 0.02
    mlp.eval()
    assert abs((hidden() == 0).float().mean().item() - relu_only) < 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(rng, masked):
    n = 50
    mask = rng.random(n) < 0.5 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    logits = (rng.normal(size=(n, 6)) * 3).astype(np.float32)
    y = rng.integers(0, 6, n)
    log_probs = np.array(jnn.log_softmax(jnp.asarray(logits)))
    binary = rng.integers(0, 2, (n, 6)).astype(np.float32)
    pred, target = rng.normal(size=(n,)).astype(np.float32), rng.normal(size=(n,)).astype(np.float32)
    cases = [
        ("nll_loss", (log_probs, y)),
        ("binary_cross_entropy_with_logits", (logits[:, 0], binary[:, 0])),
        ("mse_loss", (pred, target)),
        ("l1_loss", (pred, target)),
    ]
    for name, args in cases:
        got = getattr(tnn, name)(*(torch.from_numpy(a) for a in args), tm)
        want = getattr(jnn, name)(*(jnp.asarray(a) for a in args), jm)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=name)
    empty = torch.zeros(n, dtype=torch.bool)
    assert tnn.mse_loss(torch.from_numpy(pred), torch.from_numpy(target), empty).item() == 0.0


def test_embedding_matches_jax(rng):
    j = jnn.Embedding(11, 5, key=KEY)
    t = tnn.Embedding(11, 5, generator=torch.Generator().manual_seed(0))
    assert set(jnn.state_dict(j)) == set(t.state_dict()) == {"weight"}
    tnn.load_jax_state_dict(t, _jax_params(j))
    idx = rng.integers(0, 11, (7, 3))
    out = t(torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(out), np.asarray(j(jnp.asarray(idx))))
    out.sum().backward()
    np.testing.assert_allclose(_np(t.weight.grad).sum(1), 5 * np.bincount(idx.ravel(), minlength=11))


def test_initializers():
    gen = torch.Generator().manual_seed(0)
    n = tnn.normal((400, 300), stddev=0.5, generator=gen)
    assert abs(n.std().item() - 0.5) < 0.01 and abs(n.mean().item()) < 0.01
    assert torch.equal(tnn.zeros((3, 2)), torch.zeros(3, 2)) and torch.equal(tnn.ones((3,)), torch.ones(3))
    assert tnn.ones((2,), generator=gen, dtype=torch.bfloat16).dtype == torch.bfloat16


def test_identity_passes_x_through():
    x = torch.ones(3)
    assert tnn.Identity()(x, 1, key=None) is x


def test_buffer_state_names_the_buffers():
    from gnn_tpu_torch.models import GCN, EncoderGCN

    assert tnn.buffer_state(GCN(4, 4, 2)) == {}
    model = EncoderGCN(4, 2, num_layers=2)
    state = tnn.buffer_state(model)
    assert list(state) == [
        "convs.0.batch_norm.running_mean", "convs.0.batch_norm.running_var",
        "convs.1.batch_norm.running_mean", "convs.1.batch_norm.running_var",
    ]
    assert state["convs.1.batch_norm.running_var"] is model.convs[1].batch_norm.running_var


def test_load_jax_state_dict_with_buffers(rng):
    """Parameters by name; buffers as the State's (mean, var) pairs in the
    order of the model's BatchNorm modules. Without them the buffers keep
    their initial (0, 1)."""
    from gnn_tpu.models import EncoderGCN as JaxEncoderGCN
    from gnn_tpu_torch.models import EncoderGCN

    j = JaxEncoderGCN(6, 3, key=KEY, num_layers=2)
    t = tnn.load_jax_state_dict(EncoderGCN(6, 3, num_layers=2), _jax_params(j))
    for bn in (c.batch_norm for c in t.convs):
        assert torch.equal(bn.running_mean, torch.zeros(6)) and torch.equal(bn.running_var, torch.ones(6))
    pairs = [(rng.normal(size=6).astype(np.float32), rng.random(6).astype(np.float32) + 0.5) for _ in range(2)]
    tnn.load_jax_state_dict(t, _jax_params(j), pairs)
    for conv, (mean, var) in zip(t.convs, pairs):
        np.testing.assert_array_equal(_np(conv.batch_norm.running_mean), mean)
        np.testing.assert_array_equal(_np(conv.batch_norm.running_var), var)
    np.testing.assert_array_equal(_np(t.pre.blocks[0].weight), np.asarray(j.pre.blocks[0].weight))
    with pytest.raises(ValueError, match="pairs"):
        tnn.load_jax_state_dict(t, _jax_params(j), pairs[:1])
    with pytest.raises(ValueError, match="shape mismatch"):
        tnn.load_jax_state_dict(t, _jax_params(j), [(np.zeros(5, np.float32), np.ones(6, np.float32))] * 2)
    # the State's leaves, two at a time, are those pairs
    leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(jnn.init_state(j))]
    tnn.load_jax_state_dict(t, _jax_params(j), list(zip(leaves[0::2], leaves[1::2])))
    assert torch.equal(t.convs[1].batch_norm.running_var, torch.ones(6))
