"""Parameter initializers, drawn from an explicit ``torch.Generator``.

Port of ``gnn_tpu/nn/init.py``. The distributions match; the bits do not
(``jax.random`` and ``torch.Generator`` differ), so parity tests carry
weights across with :func:`gnn_tpu_torch.nn.convert.load_jax_state_dict`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["kaiming_uniform", "glorot_uniform", "uniform", "normal", "zeros", "ones"]


def uniform(
    shape: Sequence[int],
    *,
    minval: float,
    maxval: float,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return u * (maxval - minval) + minval


def kaiming_uniform(
    shape: Sequence[int],
    *,
    fan_in: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """U(-1/sqrt(fan_in), +1/sqrt(fan_in)); weight shape [out, in], fan_in = in."""
    if fan_in is None:
        fan_in = shape[-1] if len(shape) >= 2 else shape[0]
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return uniform(shape, minval=-bound, maxval=bound, generator=generator, dtype=dtype)


def glorot_uniform(
    shape: Sequence[int],
    *,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """U(-b, b) with b = sqrt(6 / (fan_in + fan_out)), fan_in = shape[-2]
    (shape[0] for a vector) and fan_out = shape[-1], as the JAX package
    counts them."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    bound = math.sqrt(6.0 / (fan_in + shape[-1]))
    return uniform(shape, minval=-bound, maxval=bound, generator=generator, dtype=dtype)


def normal(
    shape: Sequence[int],
    *,
    stddev: float = 1.0,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    return stddev * torch.randn(tuple(shape), generator=generator, dtype=dtype)


def zeros(shape: Sequence[int], *, generator: Optional[torch.Generator] = None, dtype=torch.float32):
    del generator
    return torch.zeros(tuple(shape), dtype=dtype)


def ones(shape: Sequence[int], *, generator: Optional[torch.Generator] = None, dtype=torch.float32):
    del generator
    return torch.ones(tuple(shape), dtype=dtype)
