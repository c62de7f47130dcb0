"""The benchmark's graphs and node inputs, frozen.

The graph generators are copies of the port's, kept here so that no later
change to the program can change what the benchmark trains on:

* :func:`power_law`, :func:`clustered_power_law`: copies of
  ``gnn_tpu_torch/graphs/generate.py``;
* :func:`remove_self_loops`, :func:`coalesce` (without weights),
  :func:`to_undirected`: copies of ``gnn_tpu_torch/graphs/transforms.py``;
* :func:`node_inputs`: the split of ``chip_smoke.py::arxiv_scale_data``
  (a 54/18/28 % train/val/test split of a random permutation), with the
  features, labels and permutation drawn on the device from the run's seed.

A public dataset is one fixed graph, so the graph's seed is the cell's
(``graph.seed``); everything on the nodes comes from ``--seed``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def remove_self_loops(ei: np.ndarray) -> np.ndarray:
    return ei[:, ei[0] != ei[1]]


def coalesce(ei: np.ndarray) -> np.ndarray:
    """Sort by (dst, src) and drop duplicate edges."""
    src, dst = ei[0].astype(np.int64), ei[1].astype(np.int64)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    keep = np.ones(len(src), bool)
    if len(src):
        keep[1:] = (dst[1:] != dst[:-1]) | (src[1:] != src[:-1])
    return np.stack([src[keep], dst[keep]])


def to_undirected(ei: np.ndarray) -> np.ndarray:
    return coalesce(np.concatenate([ei, ei[::-1]], axis=1))


def power_law(num_nodes: int, num_edges: int, *, alpha: float = 0.8, seed: int = 0) -> np.ndarray:
    """Edge list [2, E'] with power-law destination popularity (self loops
    removed, duplicates coalesced, dst-sorted)."""
    rng = np.random.default_rng(seed)
    popularity = np.arange(1, num_nodes + 1, dtype=np.float64) ** (-alpha)
    cdf = np.cumsum(popularity)
    cdf /= cdf[-1]
    src = rng.integers(0, num_nodes, num_edges)
    dst = np.searchsorted(cdf, rng.random(num_edges))
    return coalesce(remove_self_loops(np.stack([src, dst]).astype(np.int64)))


def clustered_power_law(
    num_nodes: int,
    num_edges: int,
    *,
    avg_community: int = 200,
    intra_frac: float = 0.85,
    alpha: float = 0.8,
    seed: int = 0,
    shuffle: bool = True,
) -> np.ndarray:
    """Community-structured edge list [2, E']: lognormal community sizes
    (mean ``avg_community``, at least 4); ``intra_frac`` of the edges join two
    nodes of one community, the rest are :func:`power_law` pairs;
    ``shuffle`` scatters the ids so that the communities are not visible in
    the id order."""
    rng = np.random.default_rng(seed)
    sizes, total = [], 0
    while total < num_nodes:
        s = max(4, int(rng.lognormal(np.log(avg_community), 0.6)))
        s = min(s, num_nodes - total)
        sizes.append(s)
        total += s
    starts = np.concatenate([[0], np.cumsum(sizes)])
    e_intra = int(num_edges * intra_frac)
    sizes_arr = np.asarray(sizes, np.float64)
    comm_of_edge = rng.choice(len(sizes), e_intra, p=sizes_arr / sizes_arr.sum())
    lo = starts[comm_of_edge]
    sz = sizes_arr[comm_of_edge]
    u = rng.random(e_intra) ** (1.0 / max(1.0 - alpha, 1e-3))
    src_i = lo + (rng.random(e_intra) * sz).astype(np.int64)
    dst_i = lo + (u * sz).astype(np.int64).clip(0, (sz - 1).astype(np.int64))
    inter = power_law(num_nodes, num_edges - e_intra, alpha=alpha, seed=seed + 1)
    ei = np.concatenate([np.stack([src_i, dst_i]), np.asarray(inter, np.int64)], axis=1)
    if shuffle:
        ei = rng.permutation(num_nodes)[ei]
    return coalesce(remove_self_loops(ei))


RECIPES = {"power_law": power_law, "clustered_power_law": clustered_power_law}


def edges(dataset: dict, graph: dict) -> np.ndarray:
    """The cell's graph: ``graph['recipe']`` at the dataset's published node
    and directed edge counts, with the cell's other ``graph`` keys as the
    recipe's parameters, made undirected. int64 [2, E], dst-sorted, no self
    loops."""
    params = {k: v for k, v in graph.items() if k != "recipe"}
    ei = RECIPES[graph["recipe"]](dataset["num_nodes"], dataset["num_edges"], **params)
    return to_undirected(ei)


def stream_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for each of the run's random streams."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


def node_inputs(dataset: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Features [N, F] (standard normal), labels [N] and the boolean split
    masks, on ``device``, from ``seed``."""
    n, f, c = dataset["num_nodes"], dataset["num_features"], dataset["num_classes"]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    x = torch.randn((n, f), generator=gen, device=device)
    y = torch.randint(0, c, (n,), generator=gen, device=device)
    perm = torch.randperm(n, generator=gen, device=device)
    n_train, n_val = int(dataset["split"][0] * n), int(dataset["split"][1] * n)
    masks = {}
    for name, (lo, hi) in {"train": (0, n_train), "val": (n_train, n_train + n_val), "test": (n_train + n_val, n)}.items():
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[perm[lo:hi]] = True
        masks[f"{name}_mask"] = m
    return {"x": x, "y": y, **masks}
