"""Losses and metrics with optional boolean masks.

Port of ``gnn_tpu/nn/losses.py``: every loss and ``accuracy`` reduce over
masked elements only, with the masked mean
``sum(v * mask) / max(sum(mask), 1)`` of ``_masked_mean``.

``cross_entropy`` and ``accuracy`` (what ``fit`` reduces) take a keyword
``group``: a ``torch.distributed`` process group over which the rows are
spread (each process holding some of them, as the parts of a node partition
in a group). The count of the mask is then summed
over the group (the ``max(., 1)`` applies to that sum), and the result is
this process's *share* of the group's masked mean: its own ``sum(v * mask)``
over the group's count. The shares sum over the group to the mean over all
rows; so the gradient of a share, summed over the group, is that of the
mean. Without a mask the count is the number of elements.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist

from gnn_tpu_torch.utils.tracing import emit

__all__ = [
    "cross_entropy",
    "nll_loss",
    "binary_cross_entropy_with_logits",
    "mse_loss",
    "l1_loss",
    "accuracy",
]


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor], group=None) -> torch.Tensor:
    if group is None:
        if mask is None:
            return values.mean()
        mask = mask.to(values.dtype)
        return (values * mask).sum() / mask.sum().clamp_min(1.0)
    if mask is None:
        total, count = values.sum(), torch.tensor(float(values.numel()), device=values.device)
    else:
        mask = mask.to(values.dtype)
        total, count = (values * mask).sum(), mask.sum().detach()
    tdist.all_reduce(count, group=group)
    return total / count.clamp_min(1.0)


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    label_smoothing: float = 0.0,
    group=None,
) -> torch.Tensor:
    """Softmax cross entropy with integer targets. logits [N, C], targets [N].
    The logits are emitted (``utils.tracing.emit("cross_entropy", ...)``)."""
    emit("cross_entropy", logits=logits)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    picked = log_probs.gather(-1, targets.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        picked = (1.0 - label_smoothing) * picked + label_smoothing * log_probs.mean(-1)
    return _masked_mean(-picked, mask, group)


def nll_loss(
    log_probs: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    picked = log_probs.gather(-1, targets.long()[:, None])[:, 0]
    return _masked_mean(-picked, mask)


def binary_cross_entropy_with_logits(
    logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """max(x, 0) - x * t + log(1 + e^-|x|), in float32."""
    logits, targets = logits.float(), targets.float()
    losses = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return _masked_mean(losses, mask)


def mse_loss(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(torch.square(pred - target), mask)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(torch.abs(pred - target), mask)


def accuracy(
    logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None, *, group=None
) -> torch.Tensor:
    correct = (logits.argmax(-1) == targets).float()
    return _masked_mean(correct, mask, group)
