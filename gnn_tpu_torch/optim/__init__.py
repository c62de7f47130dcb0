"""Optimizers."""

from gnn_tpu_torch.optim.adam import Adam, AdamW
from gnn_tpu_torch.optim.base import clip_by_global_norm
from gnn_tpu_torch.optim.sgd import SGD

__all__ = ["Adam", "AdamW", "SGD", "clip_by_global_norm"]
