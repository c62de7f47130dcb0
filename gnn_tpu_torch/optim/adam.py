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

from gnn_tpu_torch.ops.cuda.adam import adam_update
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
        # One update over the group's leaves (ops/cuda/adam.py): a kernel
        # launch on the card, a handful of foreach ops elsewhere, with a
        # per-leaf update's float32 arithmetic on every element either way.
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
            adam_update(
                ps, [p.grad for p in ps], [self.state[p]["exp_avg"] for p in ps],
                [self.state[p]["exp_avg_sq"] for p in ps],
                (b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps, -lr, wd, lr * wd), decoupled,
            )


class AdamW(Adam):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, lr, betas, eps, weight_decay, decoupled_weight_decay=True)
