"""Checkpoint and resume, on ``torch.save``.

Port of ``gnn_tpu/train/checkpoint.py::Checkpointer`` (which stores with
Orbax): the checkpointable view of a model is its ``state_dict``'s
parameters by qualified name (the JAX package's names), beside the
optimizer's ``state_dict``, the buffers (BatchNorm's running statistics) and
a free ``extra`` dictionary, where ``fit`` keeps its random generators'
states. One file a step, ``step_{n}.pt``, written under a temporary name and
renamed, so that a crash leaves the last complete file; the oldest files
beyond ``max_to_keep`` are deleted after each save. Files are read with
``torch.load(weights_only=True)``: tensors, numbers, strings and containers
of them, and no code.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

__all__ = ["Checkpointer"]

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def _on_cpu(tree: Any) -> Any:
    """A copy of a tree of containers with every tensor detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v) for v in tree)
    return tree


class Checkpointer:
    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        """The steps that have a complete file, ascending."""
        found = (_STEP_FILE.fullmatch(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(
        self,
        step: int,
        model: nn.Module,
        optimizer: Optional[torch.optim.Optimizer] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        extra: Optional[dict] = None,
    ) -> None:
        """``state`` is the buffer view ``fit`` returns
        (``nn.buffer_state(model)``) or None; ``extra`` may hold tensors,
        numbers, strings and lists / dicts of them."""
        payload = {"step": int(step), "model": _on_cpu(dict(model.named_parameters()))}
        if optimizer is not None:
            payload["opt_state"] = _on_cpu(optimizer.state_dict())
        if state is not None:
            payload["buffers"] = _on_cpu(dict(state))
        if extra:
            payload["extra"] = _on_cpu(extra)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        steps = self.all_steps()
        for old in steps[: max(len(steps) - self.max_to_keep, 0)]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        model: nn.Module,
        optimizer: Optional[torch.optim.Optimizer] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        step: Optional[int] = None,
    ) -> Tuple[nn.Module, Optional[torch.optim.Optimizer], Optional[Dict[str, torch.Tensor]], Optional[dict]]:
        """Load the checkpoint of ``step`` (the latest when None) *into*
        ``model``, and into ``optimizer`` and the buffers of ``state`` when
        they are given and were saved. Pass only what you want back (the
        model alone for inference). Returns (model, optimizer, state,
        extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        saved = payload["model"]
        params = dict(model.named_parameters())
        missing = [name for name in params if name not in saved]
        if missing:
            raise KeyError(f"checkpoint step {step} lacks parameters {missing}")
        with torch.no_grad():
            for name, p in params.items():
                if saved[name].shape != p.shape:
                    raise ValueError(
                        f"shape mismatch for '{name}': checkpoint {tuple(saved[name].shape)} "
                        f"vs model {tuple(p.shape)}"
                    )
                p.copy_(saved[name])
            if state is not None and "buffers" in payload:
                for name, b in state.items():
                    b.copy_(payload["buffers"][name])
        if optimizer is not None and "opt_state" in payload:
            optimizer.load_state_dict(payload["opt_state"])
        return model, optimizer, state, payload.get("extra")

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX class's
        protocol (``fit`` closes its checkpointer)."""
