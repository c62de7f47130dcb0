"""Command-line entry point.

Port of ``gnn_tpu/train/cli.py`` with a ``--device`` flag (default ``cuda``):

    python -m gnn_tpu_torch.train.cli --dataset sbm --device cuda \
        --train.epochs 100 --optim.lr 0.01

``--model.name`` is one of gcn, gat, gatv2 (full graph, one device),
encoder_gcn, sage (with ``--model.aggr mean|sum|max``) and gin;
``--optim.name`` one of adam, adamw and sgd (with ``--optim.momentum``);
``--optim.grad_clip C`` clips the gradients' global norm to C before each
step. ``--train.batch_size B --train.fanouts [10,5]``
trains sage, gat or gin on neighbour-sampled minibatches (with
``--train.host_features true`` sampled and gathered on the host);
``--train.reorder auto|true|false|cluster`` picks the node order of a
full-graph run (``auto``, the default, and ``true`` relabel by degree
bucket; ``true`` raises on a graph that is not degree-symmetric);
``--train.checkpoint_dir D [--train.checkpoint_every K]`` writes checkpoints
(``fit(resume=True)`` continues from the latest). Any Config field is overridable with a dotted
flag. --config loads a JSON config file first; dotted flags override it.

Started by ``torchrun`` with more than one process (``WORLD_SIZE``), each
process joins the group first (``parallel.multihost.initialize``: gloo for
``--device cpu``, NCCL on the cards) and ``fit`` spreads ``dist.num_parts``
over the processes; rank 0 prints the final line::

    torchrun --nproc-per-node 2 -m gnn_tpu_torch.train.cli --dataset sbm --device cpu --dist.num_parts 4
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import torch.distributed as tdist

from gnn_tpu_torch.graphs.datasets import load_dataset
from gnn_tpu_torch.parallel import multihost
from gnn_tpu_torch.train.config import Config
from gnn_tpu_torch.train.loop import fit


def parse_args(argv=None) -> Tuple[Config, str]:
    """Returns (config, device)."""
    parser = argparse.ArgumentParser(
        prog="gnn_tpu_torch.train", description="Train a GNN with PyTorch"
    )
    parser.add_argument("--config", type=str, default="", help="JSON config path")
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    if args.dataset:
        cfg.dataset = args.dataset
    if args.data_root:
        cfg.data_root = args.data_root

    overrides = []
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument: {tok}")
        key = tok[2:]
        if "=" in key:
            overrides.append(key)
            i += 1
        else:
            if i + 1 >= len(unknown):
                raise SystemExit(f"flag --{key} needs a value")
            overrides.append(f"{key}={unknown[i + 1]}")
            i += 2
    return cfg.apply_overrides(overrides), args.device


def main(argv=None) -> int:
    cfg, device = parse_args(argv)
    grouped = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if grouped:
        multihost.initialize(device=device)
    try:
        return _run(cfg, device)
    finally:
        if grouped:
            tdist.destroy_process_group()


def _run(cfg: Config, device: str) -> int:
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    print(f"config:\n{cfg.to_json()}", file=sys.stderr)
    data = load_dataset(cfg.dataset, cfg.data_root)
    print(
        f"dataset: {cfg.dataset}: {data.num_nodes} nodes, "
        f"{data.num_edges} edges, {data.num_features} features; device {device}",
        file=sys.stderr,
    )
    _, _, history = fit(cfg, data, device=device)
    if history and rank == 0:
        final = history[-1]
        print(
            "final: "
            + "  ".join(f"{k}={v:.4f}" for k, v in final.items() if isinstance(v, float))
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
