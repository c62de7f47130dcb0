"""Inverted dropout with an explicit ``torch.Generator``.

Port of ``gnn_tpu/nn/dropout.py``: a Bernoulli(1 - rate) keep mask scaled by
1/(1 - rate), applied only in training mode (``module.train()``). The mask
comes from the generator passed to ``forward`` (the default generator when
None); its bits differ from ``jax.random``'s. The draw and its application
run in the span ``dropout``, and each keep mask is emitted
(``utils.tracing.emit("dropout", ...)``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.utils.tracing import emit, span

__all__ = ["Dropout", "dropout"]


def dropout(
    x: torch.Tensor,
    rate: float,
    *,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    with span("dropout"):
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        out = torch.where(mask, x / keep, 0.0)  # a scalar 0: no tensor to allocate and fill
    emit("dropout", x=x, out=out, mask=mask, rate=rate)
    return out


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None):
        return dropout(x, self.rate, training=self.training, generator=generator)
