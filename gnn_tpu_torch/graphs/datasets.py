"""Dataset loaders.

Port of ``gnn_tpu/graphs/datasets.py``:

* the built-in synthetic datasets that need no files ('karate', 'sbm',
  'sbm-large');
* **Planetoid** (cora / citeseer / pubmed) from the standard
  ``ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}`` pickle files;
* **OGB node-property** graphs (ogbn-arxiv, ogbn-products, ...) from the
  standard extracted ``raw/`` + ``split/`` directory layout;
* a generic ``.npz`` container (keys: x, edge_index, y, train/val/test_mask).

All loaders are offline: they read local files only and raise an error that
names the expected layout when files are missing.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from gnn_tpu_torch.graphs import generate
from gnn_tpu_torch.graphs.data import Data
from gnn_tpu_torch.graphs.transforms import to_undirected

__all__ = ["load_dataset", "load_npz", "load_planetoid", "load_ogbn"]


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
    if name_l in ("cora", "citeseer", "pubmed"):
        return load_planetoid(name_l, root)
    if name_l.startswith("ogbn-"):
        return load_ogbn(name_l, root)
    if name_l.endswith(".npz"):
        return load_npz(name if os.path.exists(name) else os.path.join(root, name))
    raise ValueError(
        f"unknown dataset '{name}'. Built-ins: karate, sbm, sbm-large; "
        "file-based: cora/citeseer/pubmed (Planetoid), ogbn-*, or a .npz path"
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


def load_planetoid(name: str, root: str = "data") -> Data:
    """Planetoid citation graphs from the standard ``ind.*`` pickles (the
    layout of github.com/kimiyoung/planetoid, also used by PyG), under
    ``<root>/<name>/raw`` or ``<root>/<name>``. The pickles hold numpy arrays
    or scipy sparse matrices (unpickling the latter needs scipy)."""
    base = os.path.join(root, name, "raw")
    if not os.path.isdir(base):
        base = os.path.join(root, name)
    needed = ["x", "tx", "allx", "y", "ty", "ally", "graph"]
    paths = {k: os.path.join(base, f"ind.{name}.{k}") for k in needed}
    test_idx_path = os.path.join(base, f"ind.{name}.test.index")
    missing = [p for p in [*paths.values(), test_idx_path] if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"Planetoid '{name}' raw files not found under {base}. Expected "
            f"ind.{name}.{{x,tx,allx,y,ty,ally,graph,test.index}}. Missing: {missing[:3]}..."
        )

    def load(k):
        with open(paths[k], "rb") as f:
            return pickle.load(f, encoding="latin1")

    def dense(m):
        return np.asarray(m.todense()) if hasattr(m, "todense") else np.asarray(m)

    tx, allx = dense(load("tx")), dense(load("allx"))
    ty, ally = np.asarray(load("ty")), np.asarray(load("ally"))
    graph = load("graph")
    test_idx = np.loadtxt(test_idx_path, dtype=np.int64)
    test_sorted = np.sort(test_idx)
    # citeseer has gaps in the test-id range: widen the tx/ty block so the
    # tail rows cover the whole contiguous range (missing ids get zero rows).
    # The reorder below still runs over the ids that exist (the JAX package
    # runs it over the widened range, which fails when there is a gap).
    if name == "citeseer":
        span = int(test_sorted.max() - test_sorted.min()) + 1
        tx_full = np.zeros((span, tx.shape[1]), np.float32)
        ty_full = np.zeros((span, ty.shape[1]), ty.dtype)
        tx_full[test_sorted - test_sorted.min()] = tx
        ty_full[test_sorted - test_sorted.min()] = ty
        tx, ty = tx_full, ty_full
    features = np.vstack([allx, tx]).astype(np.float32)
    labels_oh = np.vstack([ally, ty])
    # The canonical Planetoid reorder (Kipf's gcn/utils.py): the tail rows are
    # stored in sorted-test-id order; move them to their true node ids.
    features[test_idx] = features[test_sorted]
    labels_oh[test_idx] = labels_oh[test_sorted]
    n = features.shape[0]

    src, dst = [], []
    for v, nbrs in graph.items():
        for u in nbrs:
            src.append(u)
            dst.append(v)
    ei = np.stack([np.asarray(src, np.int64), np.asarray(dst, np.int64)])
    ei, _ = to_undirected(ei, num_nodes=n)

    train_mask, val_mask, test_mask = (np.zeros(n, bool) for _ in range(3))
    ntrain = min({"cora": 140, "citeseer": 120, "pubmed": 60}[name], max(n // 4, 1))
    train_mask[:ntrain] = True
    val_mask[ntrain : min(ntrain + 500, n)] = True
    test_mask[test_idx] = True
    return Data(
        x=features, edge_index=ei, y=labels_oh.argmax(axis=1), num_nodes=n,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
    )


def load_ogbn(name: str, root: str = "data") -> Data:
    """OGB node-property datasets from the extracted standard layout::

      <root>/<name_with_underscores>/raw/{data.npz or *.csv.gz}
      <root>/<name_with_underscores>/split/<split_name>/{train,valid,test}.csv.gz

    The ``csv.gz`` files are read with pandas, imported only when one is met.
    """
    base = os.path.join(root, name.replace("-", "_"))
    raw = os.path.join(base, "raw")
    if not os.path.isdir(raw):
        raise FileNotFoundError(
            f"OGB dataset '{name}' not found: expected {raw}/ with the "
            "standard OGB extracted layout (data.npz or csv.gz files)"
        )

    def csv(path, dtype):
        import pandas as pd

        return np.array(pd.read_csv(path, compression="gzip", header=None).to_numpy(dtype))

    npz = os.path.join(raw, "data.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            x = z["node_feat"].astype(np.float32)
            ei = z["edge_index"].astype(np.int64)
            y = z["node_label"].reshape(-1)
    else:
        x = csv(os.path.join(raw, "node-feat.csv.gz"), np.float32)
        ei = csv(os.path.join(raw, "edge.csv.gz"), np.int64).T
        y = csv(os.path.join(raw, "node-label.csv.gz"), np.int64).reshape(-1)
    n = x.shape[0]

    masks = {}
    split_root = os.path.join(base, "split")
    if os.path.isdir(split_root):
        split_name = sorted(os.listdir(split_root))[0]
        for part, mname in (("train", "train_mask"), ("valid", "val_mask"), ("test", "test_mask")):
            p = os.path.join(split_root, split_name, f"{part}.csv.gz")
            if os.path.exists(p):
                m = np.zeros(n, bool)
                m[csv(p, np.int64).reshape(-1)] = True
                masks[mname] = m
    return Data(x=x, edge_index=ei, y=y, num_nodes=n, **masks)
