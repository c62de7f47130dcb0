"""Layers, initializers, losses and weight transfer from the JAX package."""

from gnn_tpu_torch.nn.activations import (
    ELU,
    GELU,
    LeakyReLU,
    LogSoftmax,
    ReLU,
    Sigmoid,
    Softmax,
    Tanh,
    elu,
    gelu,
    leaky_relu,
    log_softmax,
    relu,
    sigmoid,
    softmax,
    tanh,
)
from gnn_tpu_torch.nn.containers import MLP, Sequential, call_layer
from gnn_tpu_torch.nn.convert import load_jax_state_dict
from gnn_tpu_torch.nn.dropout import Dropout, dropout
from gnn_tpu_torch.nn.embedding import Embedding
from gnn_tpu_torch.nn.init import glorot_uniform, kaiming_uniform, normal, ones, uniform, zeros
from gnn_tpu_torch.nn.linear import Identity, Linear
from gnn_tpu_torch.nn.losses import (
    accuracy,
    binary_cross_entropy_with_logits,
    cross_entropy,
    l1_loss,
    mse_loss,
    nll_loss,
)
from gnn_tpu_torch.nn.normalization import BatchNorm, LayerNorm
from gnn_tpu_torch.nn.state import buffer_state

__all__ = [
    "relu",
    "leaky_relu",
    "gelu",
    "elu",
    "sigmoid",
    "tanh",
    "softmax",
    "log_softmax",
    "ReLU",
    "LeakyReLU",
    "GELU",
    "ELU",
    "Sigmoid",
    "Tanh",
    "Softmax",
    "LogSoftmax",
    "MLP",
    "Sequential",
    "call_layer",
    "load_jax_state_dict",
    "Dropout",
    "dropout",
    "Embedding",
    "kaiming_uniform",
    "glorot_uniform",
    "uniform",
    "normal",
    "zeros",
    "ones",
    "Identity",
    "Linear",
    "accuracy",
    "binary_cross_entropy_with_logits",
    "cross_entropy",
    "l1_loss",
    "mse_loss",
    "nll_loss",
    "BatchNorm",
    "LayerNorm",
    "buffer_state",
]
