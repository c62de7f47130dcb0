"""Embedding table.

Port of ``gnn_tpu/nn/embedding.py::Embedding``: a [num_embeddings, features]
table drawn from N(0, 1); the lookup is a row gather.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.nn import init as init_lib

__all__ = ["Embedding"]


class Embedding(nn.Module):
    def __init__(
        self,
        num_embeddings: int,
        features: int,
        *,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.weight = nn.Parameter(
            init_lib.normal((num_embeddings, features), generator=generator, dtype=dtype)
        )

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx.long()]
