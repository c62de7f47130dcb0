"""Dataset loaders.

Port of ``gnn_tpu/graphs/datasets.py::load_dataset`` for the built-in
synthetic datasets ('karate', 'sbm', 'sbm-large') and the generic ``.npz``
container (keys: x, edge_index, y, train/val/test_mask). All loaders are
offline. The Planetoid and OGB file loaders are not ported yet (ROADMAP
Queue 1 item 2) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os

import numpy as np

from gnn_tpu_torch.graphs import generate
from gnn_tpu_torch.graphs.data import Data

__all__ = ["load_dataset", "load_npz"]


def load_dataset(name: str, root: str = "data", **kwargs) -> Data:
    name_l = name.lower()
    if name_l == "karate":
        return generate.karate_club()
    if name_l == "sbm":
        return generate.stochastic_block_model(**{"num_nodes": 400, "num_classes": 4, **kwargs})
    if name_l == "sbm-large":
        return generate.stochastic_block_model(
            **{"num_nodes": 20000, "num_classes": 16, "p_in": 0.002, "p_out": 5e-5, **kwargs}
        )
    if name_l in ("cora", "citeseer", "pubmed") or name_l.startswith("ogbn-"):
        raise NotImplementedError(
            f"the '{name}' file loader is not ported yet (ROADMAP Queue 1 "
            "item 2); built-ins: karate, sbm, sbm-large, or a .npz path"
        )
    if name_l.endswith(".npz"):
        return load_npz(name if os.path.exists(name) else os.path.join(root, name))
    raise ValueError(
        f"unknown dataset '{name}'. Built-ins: karate, sbm, sbm-large; "
        "file-based: a .npz path"
    )


def load_npz(path: str) -> Data:
    """Generic container: x [N,F], edge_index [2,E], y [N], *_mask [N]."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"npz dataset not found: {path}")
    with np.load(path) as z:
        return Data(
            x=z["x"].astype(np.float32),
            edge_index=z["edge_index"].astype(np.int64),
            y=z["y"] if "y" in z else None,
            train_mask=z.get("train_mask"),
            val_mask=z.get("val_mask"),
            test_mask=z.get("test_mask"),
            num_nodes=int(z["x"].shape[0]),
        )
