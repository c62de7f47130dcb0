"""Container modules: Sequential and the MLP stack.

Port of ``gnn_tpu/nn/containers.py``. ``Sequential`` holds its layers under
``layers`` and ``MLP`` its stack under ``blocks``, so that the
``state_dict()`` names are the JAX package's (``blocks.layers.{i}.weight``;
``i`` counts the LayerNorm, ReLU and Dropout entries too). The dropout
generator is passed only to layers whose ``forward`` takes one.
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional, Sequence

import torch
from torch import nn

from gnn_tpu_torch.nn.activations import ReLU
from gnn_tpu_torch.nn.dropout import Dropout
from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.nn.normalization import LayerNorm

__all__ = ["Sequential", "MLP", "call_layer"]


@functools.lru_cache(maxsize=None)
def _takes_generator(layer_type: type) -> bool:
    try:
        return "generator" in inspect.signature(layer_type.forward).parameters
    except (TypeError, ValueError):
        return False


def call_layer(layer: nn.Module, x: torch.Tensor, *, generator: Optional[torch.Generator] = None):
    """``layer(x)``, with ``generator=`` only if its ``forward`` takes it."""
    if _takes_generator(type(layer)):
        return layer(x, generator=generator)
    return layer(x)


class Sequential(nn.Module):
    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = call_layer(layer, x, generator=generator)
        return x

    def __getitem__(self, i):
        return self.layers[i]

    def __len__(self):
        return len(self.layers)


class MLP(nn.Module):
    """[Linear -> LayerNorm -> ReLU -> Dropout] blocks and a plain Linear
    head; Dropout entries exist only when ``dropout > 0``."""

    def __init__(
        self,
        in_features: int,
        hidden_features: Sequence[int],
        *,
        dropout: float = 0.0,
        use_norm: bool = True,
        use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_features, *hidden_features]
        layers = []
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            layers.append(Linear(d_in, d_out, use_bias=use_bias, generator=generator))
            if i < len(dims) - 2:
                if use_norm:
                    layers.append(LayerNorm(d_out))
                layers.append(ReLU())
                if dropout > 0:
                    layers.append(Dropout(rate=dropout))
        self.blocks = Sequential(layers)

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None):
        return self.blocks(x, generator=generator)
