"""Layers, initializers, losses and weight transfer from the JAX package."""

from gnn_tpu_torch.nn.activations import elu, leaky_relu, relu
from gnn_tpu_torch.nn.convert import load_jax_state_dict
from gnn_tpu_torch.nn.dropout import Dropout, dropout
from gnn_tpu_torch.nn.init import glorot_uniform, kaiming_uniform, uniform
from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.nn.losses import accuracy, cross_entropy

__all__ = [
    "relu",
    "leaky_relu",
    "elu",
    "load_jax_state_dict",
    "Dropout",
    "dropout",
    "kaiming_uniform",
    "glorot_uniform",
    "uniform",
    "Linear",
    "accuracy",
    "cross_entropy",
]
