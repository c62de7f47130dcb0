"""Config tree.

A copy of ``gnn_tpu/train/config.py`` (the JAX module cannot be imported
without jax): one dataclass tree, JSON-serializable, with ``section.key=value``
overrides. The fields are the same, so a config file serves both packages;
the port's ``fit`` raises on the branch it does not run yet (partitions).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Sequence

__all__ = ["ModelConfig", "OptimConfig", "TrainConfig", "DistConfig", "Config"]


@dataclass
class ModelConfig:
    name: str = "gcn"  # gcn | gat | gatv2 | sage | encoder_gcn | gin
    hidden: int = 64
    num_layers: int = 2
    dropout: float = 0.5
    heads: int = 8  # gat and gatv2 only
    aggr: str = "mean"  # sage only


@dataclass
class OptimConfig:
    name: str = "adam"  # adam | adamw | sgd
    lr: float = 0.01
    weight_decay: float = 0.0
    momentum: float = 0.9  # sgd only
    grad_clip: float = 0.0


@dataclass
class TrainConfig:
    epochs: int = 200
    seed: int = 0
    batch_size: int = 0  # 0 = full graph; > 0 = neighbour-sampled minibatches of that many seeds
    fanouts: List[int] = field(default_factory=lambda: [10, 5])
    eval_every: int = 10
    # "auto" relabels a degree-symmetric graph's nodes by degree bucket (and
    # keeps the ids of another), "true" relabels or raises, "false" keeps the
    # ids, "cluster" relabels by community into packed windows. Sampled
    # minibatches keep the ids whatever the value.
    reorder: str = "auto"
    checkpoint_dir: str = ""  # non-empty: a final checkpoint, and fit(resume=True) reads it
    checkpoint_every: int = 0  # also after every such epoch that is evaluated
    log_file: str = ""
    patience: int = 0  # early stopping on val accuracy; 0 = off
    # sample and gather on the host, ship one [batch_nodes, F] slab a step
    # (needs batch_size > 0; pairs with Data(host_arrays=True))
    host_features: bool = False


@dataclass
class DistConfig:
    """Multi-device training knobs: ``num_parts`` graph parts (or, with a
    batch size, parts of the batch) over the mesh's ``axis_name`` axis; in a
    ``torch.distributed`` group of W processes a multiple of W."""

    num_parts: int = 0
    axis_name: str = "data"
    halo: str = "alltoall"
    cluster_order: bool = False
    local_blocked: int = 0


@dataclass
class Config:
    dataset: str = "sbm"
    data_root: str = "data"
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dist: DistConfig = field(default_factory=DistConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            dataset=d.get("dataset", "sbm"),
            data_root=d.get("data_root", "data"),
            model=ModelConfig(**d.get("model", {})),
            optim=OptimConfig(**d.get("optim", {})),
            train=TrainConfig(**d.get("train", {})),
            dist=DistConfig(**d.get("dist", {})),
        )

    def apply_overrides(self, overrides: Sequence[str]) -> "Config":
        """Apply ``section.key=value`` strings (CLI dotted overrides)."""
        cfg = Config.from_dict(json.loads(self.to_json()))
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override '{ov}' is not key=value")
            key, value = ov.split("=", 1)
            parts = key.split(".")
            target = cfg
            for p in parts[:-1]:
                if not hasattr(target, p):
                    raise ValueError(f"unknown config section '{p}'")
                target = getattr(target, p)
            leaf = parts[-1]
            if not hasattr(target, leaf):
                raise ValueError(f"unknown config key '{key}'")
            current = getattr(target, leaf)
            if isinstance(current, bool):
                parsed = value.lower() in ("1", "true", "yes")
            elif isinstance(current, int):
                parsed = int(value)
            elif isinstance(current, float):
                parsed = float(value)
            elif isinstance(current, list):
                parsed = json.loads(value)
            else:
                parsed = value
            setattr(target, leaf, parsed)
        return cfg
