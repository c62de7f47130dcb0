"""SGD with momentum / dampening / weight decay / Nesterov.

Port of ``gnn_tpu/optim/sgd.py::sgd`` as a ``torch.optim`` optimizer, with
the same arithmetic in the same order (``tests/test_torch_optim.py``):

    g <- g + wd * p
    v <- mu * v + (1 - dampening) * g        (from v = 0 at the first step too)
    d <- g + mu * v   if nesterov else   v   (d = g when mu = 0)
    p <- p - lr * d

``torch.optim.SGD`` copies g into v at the first step instead, which differs
whenever ``dampening != 0``. A parameter without a gradient is skipped.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.optim.base import Optimizer

__all__ = ["SGD"]


class SGD(Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        momentum: float = 0.0,
        dampening: float = 0.0,
        weight_decay: float = 0.0,
        nesterov: bool = False,
    ):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires momentum > 0 and dampening = 0")
        defaults = dict(
            lr=lr, momentum=momentum, dampening=dampening, weight_decay=weight_decay, nesterov=nesterov
        )
        super().__init__(params, defaults)

    def _update(self, group: dict) -> None:
        lr, mu, damp = group["lr"], group["momentum"], group["dampening"]
        wd, nesterov = group["weight_decay"], group["nesterov"]
        for p in group["params"]:
            if p.grad is None:
                continue
            g = p.grad
            if wd != 0.0:
                g = g + wd * p
            if mu == 0.0:
                d = g
            else:
                state = self.state[p]
                if not state:
                    state["velocity"] = torch.zeros_like(p)
                v = state["velocity"]
                v.mul_(mu).add_((1.0 - damp) * g)
                d = g + mu * v if nesterov else v
            p.add_(-lr * d)
