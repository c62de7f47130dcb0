"""Adam's update of a group of leaves on one kernel (``csrc/adam.cu``) and
its plain version, the foreach ops of ``optim/adam.py``.

The update, term by term, each term one float32 rounding in this order:

    g <- g + p*wd                              [Adam: coupled L2]
    m <- m*b1 + g*(1-b1) ;  v <- v*b2 + (g*g)*(1-b2)
    p <- p + ((m/bc1)*(-lr)) / (sqrt(v/bc2) + eps)  [- p*(lr*wd) for AdamW]

``scalars`` holds (b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps, -lr, wd, lr *
wd) as Python floats; each is rounded to float32 where it meets the
tensors, by a foreach op or by the kernel's arguments alike.

:func:`adam_update` launches the kernel when every leaf, gradient and
moment is a contiguous float32 tensor on one card, and takes
:func:`adam_update_plain` otherwise (CPU tensors, other dtypes). It counts
its launches in ``adam_update.launches``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from gnn_tpu_torch.ops.cuda import _build, _launch

__all__ = ["adam_update", "adam_update_plain"]


def adam_update_plain(ps: List[torch.Tensor], gs: List[torch.Tensor], ms: List[torch.Tensor],
                      vs: List[torch.Tensor], scalars: Sequence[float], decoupled: bool) -> None:
    """Plain version of the kernel: one foreach op a term, over all leaves."""
    b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, neg_lr, wd, lr_wd = scalars
    if wd != 0.0 and not decoupled:
        gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, one_minus_b1))
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs), one_minus_b2))
    den = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_mul(torch._foreach_div(ms, bc1), neg_lr), den)
    if wd != 0.0 and decoupled:
        torch._foreach_sub_(upd, torch._foreach_mul(ps, lr_wd))
    torch._foreach_add_(ps, upd)


def _on_card(dev: torch.device, *lists: List[torch.Tensor]) -> bool:
    return dev.type == "cuda" and all(
        t.device == dev and t.dtype == torch.float32 and t.is_contiguous() for ts in lists for t in ts
    )


def adam_update(ps: List[torch.Tensor], gs: List[torch.Tensor], ms: List[torch.Tensor],
                vs: List[torch.Tensor], scalars: Sequence[float], decoupled: bool) -> None:
    """Updates the leaves ``ps`` and their moments ``ms``, ``vs`` in place
    from the gradients ``gs`` (four lists of one length, matching shapes)."""
    if not ps:
        return
    dev = ps[0].device
    if not _on_card(dev, ps, gs, ms, vs):
        return adam_update_plain(ps, gs, ms, vs, scalars, decoupled)
    n = len(ps)
    pointers = [(ctypes.c_void_p * n)(*[t.data_ptr() for t in ts]) for ts in (ps, gs, ms, vs)]
    sizes = (ctypes.c_int64 * n)(*[p.numel() for p in ps])
    lib = _build.load()
    with _launch.on(dev):
        rc = lib.gnn_adam_f32(*pointers, sizes, n, (ctypes.c_float * 10)(*scalars), int(decoupled),
                              _launch.stream(dev))
    _launch.raise_on_error("adam_update", rc)
    adam_update.launches += 1


adam_update.launches = 0
