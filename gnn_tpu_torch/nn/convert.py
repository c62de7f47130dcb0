"""Carry weights from the JAX package into a port model.

The JAX package names every parameter by its attribute path
(``gnn_tpu/nn/module.py::named_parameters``, ``state_dict``), e.g.
``convs.0.lin.weight`` and ``convs.0.bias``. The port's modules are built so
that their ``state_dict()`` keys are the same names, and both store
``Linear.weight`` as [out, in], so no layout change is needed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_state_dict"]


def load_jax_state_dict(model: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``{name: array}`` (e.g. ``{k: np.asarray(v) for k, v in
    gnn_tpu.nn.state_dict(jax_model).items()}``) into ``model``'s parameters
    and return it. Raises KeyError on a missing name, ValueError on a shape
    mismatch."""
    own = model.state_dict()
    for name, dst in own.items():
        if name not in params:
            raise KeyError(f"state dict is missing parameter '{name}'")
        src = np.asarray(params[name])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"shape mismatch for '{name}': checkpoint {tuple(src.shape)} "
                f"vs model {tuple(dst.shape)}"
            )
    with torch.no_grad():
        for name, dst in own.items():
            dst.copy_(torch.from_numpy(np.array(params[name], copy=True)).to(dst.dtype))
    return model
