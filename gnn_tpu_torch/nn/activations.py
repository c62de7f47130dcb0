"""Activations, as functions and as modules.

Port of ``gnn_tpu/nn/activations.py``. ``gelu`` is the tanh approximation,
which is ``jax.nn.gelu``'s default (torch's own default is the exact erf
form); ``sigmoid`` is 1 / (1 + e^-x).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
]

relu = torch.relu
sigmoid = torch.sigmoid
tanh = torch.tanh


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """``jax.nn.leaky_relu``: x where x >= 0, else negative_slope * x."""
    return F.leaky_relu(x, negative_slope)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default ``approximate=True`` (tanh form)."""
    return F.gelu(x, approximate="tanh")


def elu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.elu`` with alpha = 1."""
    return F.elu(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


class ReLU(nn.Module):
    def forward(self, x):
        return relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return leaky_relu(x, self.negative_slope)


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class ELU(nn.Module):
    def forward(self, x):
        return elu(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return sigmoid(x)


class Tanh(nn.Module):
    def forward(self, x):
        return tanh(x)


class Softmax(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return softmax(x, self.axis)


class LogSoftmax(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return log_softmax(x, self.axis)
