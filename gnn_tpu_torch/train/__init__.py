"""Config, metrics and the full-graph training loop."""

from gnn_tpu_torch.train.config import (
    Config,
    DistConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from gnn_tpu_torch.train.loop import build_model, build_optimizer, evaluate, fit
from gnn_tpu_torch.train.metrics import MetricLogger, Throughput

__all__ = [
    "Config",
    "DistConfig",
    "ModelConfig",
    "OptimConfig",
    "TrainConfig",
    "build_model",
    "build_optimizer",
    "evaluate",
    "fit",
    "MetricLogger",
    "Throughput",
]
