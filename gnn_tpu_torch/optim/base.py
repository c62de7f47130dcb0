"""The port's optimizers' base, and gradient transformations applied before
an optimizer's step.

:class:`Optimizer` is ``torch.optim.Optimizer`` with the port's spans: its
``zero_grad`` runs in ``optim.zero_grad`` and its ``step`` in ``optim.step``
(every kernel of the update); a subclass writes ``_update(group)``,
the update of one parameter group. :func:`clip_by_global_norm` is the port
of ``gnn_tpu/optim/base.py::clip_by_global_norm``. The JAX package chains it
in front of the optimizer (``chain(clip_by_global_norm(c), base)``); here it
rescales the ``.grad`` of the parameters in place, between ``backward()``
and ``step()``.
"""

from __future__ import annotations

from typing import Iterable

import torch

from gnn_tpu_torch.utils.tracing import span

__all__ = ["Optimizer", "clip_by_global_norm"]


class Optimizer(torch.optim.Optimizer):
    def zero_grad(self, set_to_none: bool = True) -> None:
        with span("optim.zero_grad"):
            super().zero_grad(set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with span("optim.step"):
            for group in self.param_groups:
                self._update(group)
        return loss

    def _update(self, group: dict) -> None:
        raise NotImplementedError


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
