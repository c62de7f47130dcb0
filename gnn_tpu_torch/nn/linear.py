"""Dense layer and Identity.

Port of ``gnn_tpu/nn/linear.py::Linear``: weight [out, in] (the JAX
package's layout, so weights transfer without a transpose), Kaiming-uniform
init, forward x @ W^T + b. The product is a plain ``torch`` matmul.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.nn import init as init_lib

__all__ = ["Linear", "Identity"]


class Linear(nn.Module):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(
            init_lib.kaiming_uniform(
                (out_features, in_features), fan_in=in_features, generator=generator, dtype=dtype
            )
        )
        if use_bias:
            self.bias = nn.Parameter(
                init_lib.kaiming_uniform(
                    (out_features,), fan_in=in_features, generator=generator, dtype=dtype
                )
            )
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.t().to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Identity(nn.Module):
    def forward(self, x, *args, **kwargs):
        return x
