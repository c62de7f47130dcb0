"""Where the buffer state lives.

The JAX package keeps non-trainable values (BatchNorm's running mean and
variance) out of the model, in a functional ``State`` store that is threaded
through every forward call (``gnn_tpu/nn/state.py``: ``StateIndex``,
``State``, ``init_state``, ``make_with_state``). A ``torch.nn.Module`` holds
such values itself, as registered buffers that ``forward`` updates in place in
training mode, so the port has no store, no index and no ``state=`` argument.
:func:`buffer_state` gives the view of them that the JAX ``fit`` returns in
its middle slot.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

__all__ = ["buffer_state"]


def buffer_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{qualified name: tensor}`` of every buffer of ``model``, in
    construction order (``convs.0.batch_norm.running_mean`` ...). The tensors
    are the live buffers, not copies. Empty for a model without buffers."""
    return dict(model.named_buffers())
