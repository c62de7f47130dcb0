"""Full-graph training loop.

Port of the single-device full-graph branch of ``gnn_tpu/train/loop.py::fit``:
one-time prep (exact ``gcn_norm`` and the CSR adjacency, with the
cluster-blocked layouts and relabelled nodes under
``train.reorder='cluster'``, moved to the device), then per epoch the model
-> masked cross entropy -> backward -> (gradient clipping ->) Adam, AdamW or
SGD, with evaluation, metrics and early stopping on validation accuracy. It
trains every ``model.name`` of the config: ``gcn``, ``gat`` (ignores the edge
weights), ``encoder_gcn`` (BatchNorm buffers: updated by the train step, read
by the evaluation, returned in the middle slot), ``sage`` (scales its
messages by the ``gcn_norm`` weights, as the JAX ``fit`` hands them to every
model) and ``gin`` (drops them). Sampled minibatches, multi-device
partitions, host-resident features, checkpoints and the degree-bucket
relabelling (``train.reorder='true'``) are not ported yet: their settings
raise ``NotImplementedError`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.graphs.data import Data
from gnn_tpu_torch.models import GAT, GCN, GIN, EncoderGCN, GraphSAGE
from gnn_tpu_torch.nn.losses import accuracy, cross_entropy
from gnn_tpu_torch.nn.state import buffer_state
from gnn_tpu_torch.optim import SGD, Adam, AdamW, clip_by_global_norm
from gnn_tpu_torch.train.config import Config
from gnn_tpu_torch.train.metrics import MetricLogger, Throughput

__all__ = ["build_model", "build_optimizer", "fit", "evaluate"]

_SPLITS = ("train", "val", "test")


def build_model(
    cfg: Config, in_features: int, num_classes: int, generator: Optional[torch.Generator] = None
) -> nn.Module:
    m = cfg.model
    if m.name == "gcn":
        return GCN(
            in_features, m.hidden, num_classes,
            num_layers=m.num_layers, dropout=m.dropout, generator=generator,
        )
    if m.name == "gat":
        return GAT(
            in_features, m.hidden, num_classes,
            num_layers=m.num_layers, heads=m.heads, dropout=m.dropout, generator=generator,
        )
    if m.name == "sage":
        return GraphSAGE(
            in_features, m.hidden, num_classes,
            num_layers=m.num_layers, aggr=m.aggr, dropout=m.dropout, generator=generator,
        )
    if m.name == "gin":
        return GIN(in_features, m.hidden, num_classes, num_layers=m.num_layers, generator=generator)
    if m.name == "encoder_gcn":
        return EncoderGCN(
            in_features, num_classes, num_layers=m.num_layers, dropout=m.dropout, generator=generator
        )
    raise ValueError(f"unknown model '{m.name}'")


def build_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.optim.name``. ``optim.grad_clip`` is not part
    of it: ``fit`` clips the gradients before each step."""
    o = cfg.optim
    if o.name == "adam":
        return Adam(params, lr=o.lr, weight_decay=o.weight_decay)
    if o.name == "adamw":
        return AdamW(params, lr=o.lr, weight_decay=o.weight_decay)
    if o.name == "sgd":
        return SGD(params, lr=o.lr, momentum=o.momentum, weight_decay=o.weight_decay)
    raise ValueError(f"unknown optimizer '{o.name}'")


def _check_supported(cfg: Config) -> None:
    t = cfg.train
    unported = {
        "train.batch_size > 0 (sampled minibatches, ROADMAP Queue 1 item 13)": t.batch_size > 0,
        "dist.num_parts > 1 (multi-device partitions, ROADMAP Queue 1 item 15)": cfg.dist.num_parts > 1,
        "train.host_features (ROADMAP Queue 1 item 13)": t.host_features,
        "train.checkpoint_dir (checkpointing, ROADMAP Queue 1 item 7)": bool(t.checkpoint_dir),
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported yet")
    reorder = str(t.reorder).lower()
    if reorder == "true":
        raise NotImplementedError(
            "train.reorder='true' (the degree-bucket relabelling) is not ported yet "
            "(ROADMAP Queue 1 item 9); use 'auto', 'false' or 'cluster'"
        )
    if reorder not in ("auto", "false", "cluster"):
        raise ValueError(f"unknown train.reorder '{t.reorder}'")


@torch.no_grad()
def evaluate(model: nn.Module, data: Data, adj: Adjacency) -> dict:
    """Accuracy per split, in inference mode (dropout off, BatchNorm on its
    running statistics)."""
    was_training = model.training
    model.eval()
    logits = model(data.x, adj)
    model.train(was_training)
    out = {}
    for split in _SPLITS:
        mask = getattr(data, f"{split}_mask")
        if mask is not None:
            out[f"{split}_acc"] = float(accuracy(logits, data.y, mask))
    return out


def fit(
    cfg: Config,
    data: Data,
    *,
    model: Optional[nn.Module] = None,
    device="cuda",
    verbose: bool = True,
) -> Tuple[nn.Module, Optional[Dict[str, torch.Tensor]], list]:
    """Train per config on ``device``. Returns (trained model, buffer state,
    history); the buffer state is ``buffer_state(model)`` for a model with
    buffers (EncoderGCN's running statistics) and None otherwise.

    Early stopping restores the best epoch's *parameters* only, as the JAX
    ``fit`` does: the buffers stay those of the last epoch run.

    Each history entry holds the split accuracies, ``loss`` (of the epoch's
    step), ``edges_per_s`` since the start, and ``step_ms``: the wall time
    from the start of the epoch's step to its loss on the host (a sync).
    """
    _check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda') needs a CUDA device; none is available")
    if model is None:
        model = build_model(
            cfg, data.num_features, int(data.y.max()) + 1,
            torch.Generator().manual_seed(cfg.train.seed),
        )
    model = model.to(device)
    model.train()
    # train.reorder='cluster': relabel the nodes into community-packed
    # windows for the blocked layout (exact: GNNs are permutation-
    # equivariant; features, labels and masks move with the nodes).
    reorder = "cluster" if str(cfg.train.reorder).lower() == "cluster" else False
    adj = data.to_adjacency(norm="sym", reorder=reorder)
    if adj.perm is not None:
        data = data.permute_nodes(adj.perm)
    adj = adj.to(device)
    data = data.to(device)
    params = list(model.parameters())
    opt = build_optimizer(cfg, params)
    dropout_gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)
    logger = MetricLogger(cfg.train.log_file, echo=verbose)

    history = []
    best_val, best_state, patience_left = -1.0, None, cfg.train.patience
    thr = Throughput(data.num_edges)
    thr.start()
    for epoch in range(cfg.train.epochs):
        t_step = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy(model(data.x, adj, generator=dropout_gen), data.y, data.train_mask)
        loss.backward()
        if cfg.optim.grad_clip > 0:
            clip_by_global_norm(params, cfg.optim.grad_clip)
        opt.step()
        thr.step()
        if (epoch + 1) % cfg.train.eval_every == 0 or epoch == cfg.train.epochs - 1:
            loss_value = loss.item()  # syncs the device
            step_ms = (time.perf_counter() - t_step) * 1e3
            edges_per_s = thr.edges_per_s
            metrics = evaluate(model, data, adj)
            metrics.update(loss=loss_value, edges_per_s=edges_per_s, step_ms=step_ms)
            logger.log(epoch + 1, **metrics)
            history.append(metrics)
            val = metrics.get("val_acc")
            if cfg.train.patience and val is not None:
                if val > best_val:
                    best_val, patience_left = val, cfg.train.patience
                    best_state = {k: p.detach().clone() for k, p in model.named_parameters()}
                else:
                    patience_left -= 1
                    if patience_left <= 0:
                        break

    if best_state is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(best_state[name])
    logger.close()
    return model, buffer_state(model) or None, history
