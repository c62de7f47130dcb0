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
        # Each term is one foreach op over the group's leaves, with a per-leaf
        # update's float32 arithmetic on every element, so that a step costs
        # the host a handful of launches however many leaves the model has.
        # Leaves are grouped by their step count (a leaf without a gradient
        # skips a step).
        lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
        wd, decoupled = group["weight_decay"], group["decoupled_weight_decay"]
        by_step = {}
        for p in group["params"]:
            if p.grad is None:
                continue
            state = self.state[p]
            if not state:
                state["step"] = 0
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
            state["step"] += 1
            by_step.setdefault(state["step"], []).append(p)
        for step, ps in by_step.items():
            t = np.float32(step)
            bc1 = float(np.float32(1) - np.float32(b1) ** t)
            bc2 = float(np.float32(1) - np.float32(b2) ** t)
            gs = [p.grad for p in ps]
            if wd != 0.0 and not decoupled:
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
            ms = [self.state[p]["exp_avg"] for p in ps]
            vs = [self.state[p]["exp_avg_sq"] for p in ps]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(torch._foreach_mul(torch._foreach_div(ms, bc1), -lr), den)
            if wd != 0.0 and decoupled:
                torch._foreach_sub_(upd, torch._foreach_mul(ps, lr * wd))
            torch._foreach_add_(ps, upd)


class AdamW(Adam):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, lr, betas, eps, weight_decay, decoupled_weight_decay=True)
