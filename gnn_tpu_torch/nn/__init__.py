"""Layers, initializers, losses and weight transfer from the JAX package."""

from gnn_tpu_torch.nn.activations import relu
from gnn_tpu_torch.nn.convert import load_jax_state_dict
from gnn_tpu_torch.nn.dropout import Dropout, dropout
from gnn_tpu_torch.nn.init import kaiming_uniform, uniform
from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.nn.losses import accuracy, cross_entropy

__all__ = [
    "relu",
    "load_jax_state_dict",
    "Dropout",
    "dropout",
    "kaiming_uniform",
    "uniform",
    "Linear",
    "accuracy",
    "cross_entropy",
]
