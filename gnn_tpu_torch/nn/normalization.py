"""LayerNorm and BatchNorm, written out.

Port of ``gnn_tpu/nn/normalization.py``. Both take their statistics in
float32 whatever x's dtype and return x's dtype; both use the biased
variance to normalize. ``LayerNorm`` is ``torch.nn.functional.layer_norm`` on
the float32 input (the same arithmetic, fused); ``BatchNorm`` is written out,
because its masked statistics and its running-variance rule are not
``torch.nn.BatchNorm1d``'s.

``BatchNorm`` normalizes over all leading axes. In training mode
(``module.train()``) the batch statistics normalize and the running
statistics move as ``running * (1 - m) + new * m`` with the *unbiased*
variance ``var * n / max(n - 1, 1)`` and no gradient through them; in
``module.eval()`` the running statistics normalize. ``mask`` (bool, shape
``x.shape[:-1]``) leaves rows out of the statistics, not out of the output.
The running mean and variance are float32 buffers of the module: the JAX
package keeps them in its ``State`` store (see :mod:`gnn_tpu_torch.nn.state`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LayerNorm", "BatchNorm"]


def _affine(module: nn.Module, num_features: int, on: bool, dtype) -> None:
    if on:
        module.weight = nn.Parameter(torch.ones(num_features, dtype=dtype))
        module.bias = nn.Parameter(torch.zeros(num_features, dtype=dtype))
    else:
        module.register_parameter("weight", None)
        module.register_parameter("bias", None)


class LayerNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        *,
        eps: float = 1e-5,
        elementwise_affine: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        _affine(self, num_features, elementwise_affine, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one fused library kernel each way instead of a dozen elementwise ones
        weight, bias = self.weight, self.bias
        if weight is not None and weight.dtype != torch.float32:
            weight, bias = weight.float(), bias.float()
        y = F.layer_norm(x.float(), (self.num_features,), weight, bias, self.eps)
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        *,
        eps: float = 1e-5,
        momentum: float = 0.1,
        affine: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        _affine(self, num_features, affine, dtype)
        self.register_buffer("running_mean", torch.zeros(num_features, dtype=torch.float32))
        self.register_buffer("running_var", torch.ones(num_features, dtype=torch.float32))

    def forward(self, x: torch.Tensor, *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            if mask is None:
                mean = xf.mean(axes)
                var = xf.var(axes, unbiased=False)
                n = max(x.numel() // self.num_features, 1)
                unbiased = var * (n / max(n - 1, 1))
            else:
                if mask.shape != x.shape[:-1]:
                    raise ValueError(
                        f"BatchNorm mask shape {tuple(mask.shape)} must equal "
                        f"x.shape[:-1] = {tuple(x.shape[:-1])}"
                    )
                w = mask.float().unsqueeze(-1)
                cnt = w.sum().clamp_min(1.0)
                mean = (xf * w).sum(axes) / cnt
                # two passes: the masked mean first, then the squared distances
                var = (((xf - mean) ** 2) * w).sum(axes) / cnt
                unbiased = var * (cnt / (cnt - 1.0).clamp_min(1.0))
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(m * unbiased.detach())
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y.to(x.dtype)
