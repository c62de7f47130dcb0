"""gnn_tpu_torch — the PyTorch / CUDA port of ``gnn_tpu`` for NVIDIA Hopper.

The single-device training paths of ``gnn_tpu`` (full graph in the JAX
package's node orders, sampled minibatches, host features, host-streamed
aggregation), in PyTorch, with the sparse aggregation on hand-written CUDA
kernels for ``sm_90a`` (``csrc/``, built with ``nvcc`` at first launch).
Module names mirror ``gnn_tpu``; the JAX package stays the reference the
tests hold this one against. This package never imports jax.
"""

from gnn_tpu_torch import graphs, models, mp, nn, ops, optim, train

__version__ = "0.1.0"

__all__ = ["graphs", "models", "mp", "nn", "ops", "optim", "train"]
