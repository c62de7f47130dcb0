"""Activations. Port of ``gnn_tpu/nn/activations.py``, as far as the ported
models use it (ReLU); the others come with the models that need them."""

from __future__ import annotations

import torch

__all__ = ["relu"]

relu = torch.relu
