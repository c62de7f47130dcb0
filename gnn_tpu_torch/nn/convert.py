"""Carry weights from the JAX package into a port model.

The JAX package names every parameter by its attribute path
(``gnn_tpu/nn/module.py::named_parameters``, ``state_dict``), e.g.
``convs.0.lin.weight`` and ``pre.blocks.layers.0.weight``. The port's modules
are built so that their parameter names are the same, and both store
``Linear.weight`` as [out, in], so no layout change is needed.

Buffers travel apart from the parameters, because the JAX package holds them
apart: its ``state_dict`` has the parameters only, and BatchNorm's running
statistics sit in the ``State`` store as one (mean, var) pair per BatchNorm,
keyed by markers that ascend in construction order.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gnn_tpu_torch.nn.normalization import BatchNorm

__all__ = ["load_jax_state_dict"]


def _checked(name: str, src, dst: torch.Tensor) -> np.ndarray:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(
            f"shape mismatch for '{name}': checkpoint {tuple(src.shape)} vs model {tuple(dst.shape)}"
        )
    return src


def load_jax_state_dict(
    model: nn.Module,
    params: Mapping[str, np.ndarray],
    buffers: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
) -> nn.Module:
    """Copy ``{name: array}`` (e.g. ``{k: np.asarray(v) for k, v in
    gnn_tpu.nn.state_dict(jax_model).items()}``) into ``model``'s parameters
    and return it. Names in ``params`` that the model has no parameter for
    are ignored. Raises KeyError on a missing name, ValueError on a shape
    mismatch.

    ``buffers``: the JAX ``State``'s (running mean, running var) pairs as
    numpy arrays, one per BatchNorm of ``model`` in construction order (the
    order of ``jax.tree_util.tree_leaves(state)``, taken two at a time).
    Without it the buffers keep their values, which for a new model are the
    (0, 1) that ``gnn_tpu.nn.init_state`` gives."""
    copies = []
    for name, dst in model.named_parameters():
        if name not in params:
            raise KeyError(f"state dict is missing parameter '{name}'")
        copies.append((dst, _checked(name, params[name], dst)))
    if buffers is not None:
        norms = [(n, m) for n, m in model.named_modules() if isinstance(m, BatchNorm)]
        if len(buffers) != len(norms):
            raise ValueError(f"got {len(buffers)} (mean, var) pairs for {len(norms)} BatchNorm modules")
        for (name, bn), (mean, var) in zip(norms, buffers):
            copies.append((bn.running_mean, _checked(f"{name}.running_mean", mean, bn.running_mean)))
            copies.append((bn.running_var, _checked(f"{name}.running_var", var, bn.running_var)))
    with torch.no_grad():
        for dst, src in copies:
            dst.copy_(torch.from_numpy(np.array(src, copy=True)).to(dst.dtype))
    return model
