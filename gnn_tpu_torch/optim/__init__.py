"""Optimizers."""

from gnn_tpu_torch.optim.adam import Adam, AdamW

__all__ = ["Adam", "AdamW"]
