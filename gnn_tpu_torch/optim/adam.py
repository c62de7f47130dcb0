"""Adam / AdamW.

Port of ``gnn_tpu/optim/adam.py::adam``/``adamw`` as ``torch.optim``
optimizers, with the same arithmetic in the same order so that both packages
take the same steps (``tests/test_torch_optim.py``):

    g <- g + wd*p                     [Adam: coupled L2]
    m <- b1*m + (1-b1)*g ;  v <- b2*v + (1-b2)*g^2
    m_hat = m/(1-b1^t) ;  v_hat = v/(1-b2^t)       (bias corrections in float32)
    p <- p - lr * m_hat / (sqrt(v_hat) + eps)  [- lr*wd*p for AdamW]
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_tpu_torch.optim.base import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        *,
        decoupled_weight_decay: bool = False,
    ):
        defaults = dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            decoupled_weight_decay=decoupled_weight_decay,
        )
        super().__init__(params, defaults)

    def _update(self, group: dict) -> None:
        lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
        wd, decoupled = group["weight_decay"], group["decoupled_weight_decay"]
        for p in group["params"]:
            if p.grad is None:
                continue
            g = p.grad
            if wd != 0.0 and not decoupled:
                g = g + wd * p
            state = self.state[p]
            if not state:
                state["step"] = 0
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
            state["step"] += 1
            t = np.float32(state["step"])
            bc1 = float(np.float32(1) - np.float32(b1) ** t)
            bc2 = float(np.float32(1) - np.float32(b2) ** t)
            m, v = state["exp_avg"], state["exp_avg_sq"]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            upd = (-lr * (m / bc1)) / ((v / bc2).sqrt() + eps)
            if wd != 0.0 and decoupled:
                upd = upd - lr * wd * p
            p.add_(upd)


class AdamW(Adam):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, lr, betas, eps, weight_decay, decoupled_weight_decay=True)
