"""Activations. Port of ``gnn_tpu/nn/activations.py``, as far as the ported
models use it (ReLU for GCN, LeakyReLU and ELU for GAT); the others come with
the models that need them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["relu", "leaky_relu", "elu"]

relu = torch.relu


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """``jax.nn.leaky_relu``: x where x >= 0, else negative_slope * x."""
    return F.leaky_relu(x, negative_slope)


def elu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.elu`` with alpha = 1."""
    return F.elu(x)
