"""Config, metrics, checkpoints, the host-feature loader and the training
loops (full graph and sampled minibatches)."""

from gnn_tpu_torch.train.checkpoint import Checkpointer
from gnn_tpu_torch.train.config import (
    Config,
    DistConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from gnn_tpu_torch.train.host_loader import HostBatchLoader
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
    "Checkpointer",
    "HostBatchLoader",
]
