"""Gradient transformations applied before an optimizer's step.

Port of ``gnn_tpu/optim/base.py::clip_by_global_norm``. The JAX package
chains it in front of the optimizer (``chain(clip_by_global_norm(c), base)``);
here it rescales the ``.grad`` of the parameters in place, between
``backward()`` and ``step()``.
"""

from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["clip_by_global_norm"]


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-12))``, the
    norm taken over all gradients together. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = (max_norm / (gnorm + 1e-12)).clamp_max(1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return gnorm
