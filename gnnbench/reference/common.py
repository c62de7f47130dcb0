"""What every reference shares: precision, the GCN normalization, the loss
and Adam, in plain PyTorch.

A reference computes in ``Precision.dtype`` (float64 for the reference
itself). The control of the comparison is the reference one precision below
the configuration's float32 with TF32 off: float32 matrix products in TF32
(``Precision(torch.float32, tf32=True)``). On the card that is the card's own
TF32, forward and backward; on the CPU, which has none, the operands of
every product are rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False


REFERENCE = Precision()
CONTROL = Precision(torch.float32, tf32=True)


def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10 mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32MatmulOnCpu(torch.autograd.Function):
    """x @ w^T with the operands of the product and of both its gradients'
    products rounded to TF32, as the card's TF32 products take them."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = _round_tf32(x), _round_tf32(w)
        ctx.save_for_backward(x, w)
        return x @ w.t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ w, g.t() @ x


@contextlib.contextmanager
def scope(prec: Precision):
    """TF32 on the card's float32 products, forward and backward, for a
    control; off otherwise."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = prec.tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(x: torch.Tensor, weight: torch.Tensor, prec: Precision) -> torch.Tensor:
    """x @ weight^T, weight [out, in]; inside :func:`scope`."""
    if prec.tf32 and not x.is_cuda:
        return _Tf32MatmulOnCpu.apply(x, weight)
    return x @ weight.t()


def with_self_loops(edge_index: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[2, E] (src, dst) of a graph without self loops, plus (i, i) for every
    node, sorted by (dst, src)."""
    loops = torch.arange(num_nodes, device=edge_index.device)
    ei = torch.cat([edge_index, torch.stack([loops, loops])], dim=1)
    order = torch.argsort(ei[1] * num_nodes + ei[0])
    return ei[:, order]


def gcn_weights(edge_index: torch.Tensor, num_nodes: int, dtype: torch.dtype) -> torch.Tensor:
    """The symmetric normalization d_dst^-1/2 d_src^-1/2 of every edge of a
    graph that carries its self loops; d is the in-degree."""
    deg = torch.zeros(num_nodes, dtype=dtype, device=edge_index.device)
    deg.index_add_(0, edge_index[1], torch.ones(edge_index.shape[1], dtype=dtype, device=edge_index.device))
    dinv = deg.pow(-0.5)
    return dinv[edge_index[1]] * dinv[edge_index[0]]


def dropout(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout with a given keep mask."""
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy of the rows given."""
    return -torch.log_softmax(logits, dim=-1).gather(1, y[:, None]).mean()


def init_params(shapes: Dict[str, tuple], seed_gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The run's initial weights, float32, from one uniform draw on
    ``device``: a matrix [out, in] (and the [heads, F] attention vectors)
    uniform within the Glorot bound sqrt(6 / (in + out)), a vector [n]
    within sqrt(3 / n)."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.rand(total, generator=seed_gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        fan = shape[0] + shape[1] if len(shape) == 2 else 2 * shape[0]
        out[name] = (flat[at : at + n] * (6.0 / fan) ** 0.5).view(shape)
        at += n
    return out


class Adam:
    """Adam (Kingma and Ba), lr and the default betas and eps; an L2
    penalty is in the gradients it is given."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        for name, p in params.items():
            g = grads[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = m / (1 - self.b1**self.t)
            v_hat = v / (1 - self.b2**self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train(loss_fn, params0: Dict[str, torch.Tensor], optim: dict, steps: int, prec: Precision, alter=None) -> dict:
    """``steps`` steps of Adam from ``params0`` on ``loss_fn(params, step)``,
    which returns (loss, logits): each step's loss, the first step's logits
    and gradients, and the parameters after the last step. An
    ``optim['weight_decay']`` is the L2 penalty's gradient ``wd * p`` added to
    every parameter's (Adam's coupled weight decay); the first gradients are
    taken with it, as the optimizer gets them. ``alter(step, grads)``, where
    given, changes the gradients before the update (a fault planted for the
    comparison's limits)."""
    if optim["name"] != "adam":
        raise NotImplementedError(f"the reference trains with Adam, not {optim}")
    wd = optim.get("weight_decay", 0.0)
    params = {k: v.to(prec.dtype).clone().requires_grad_(True) for k, v in params0.items()}
    opt = Adam(optim["lr"])
    losses, first_grads, first_logits = [], None, None
    with scope(prec):
        for s in range(steps):
            loss, logits = loss_fn(params, s)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if wd:
                grads = {k: g + wd * params[k].detach() for k, g in grads.items()}
            if alter is not None:
                alter(s, grads)
            if first_grads is None:
                first_grads = {k: g.detach() for k, g in grads.items()}
                first_logits = logits.detach()
            opt.step(params, grads)
            losses.append(float(loss.detach()))
            del loss, logits, grads
    return {"losses": losses, "first_grads": first_grads, "first_logits": first_logits,
            "params": {k: p.detach() for k, p in params.items()}}
