"""Synthetic graph generators.

Port of ``gnn_tpu/graphs/generate.py``. Each generator makes the same numpy
calls in the same order as its counterpart, so the same seed gives identical
arrays (compared in ``tests/test_torch_graphs.py``):

* :func:`stochastic_block_model` — planted communities with
  class-informative features and split masks;
* :func:`cora_like` — a seeded stand-in with Planetoid Cora's published
  statistics (2708 nodes, 5278 pairs, 7 classes, 1433 binary features, the
  140/500/1000 split);
* :func:`random_regular` — approximately d-regular directed edges;
* :func:`power_law` — skewed destination popularity (ogbn-arxiv-like);
* :func:`clustered_power_law` — community-structured power-law edges with
  shuffled ids, at scale (the community relabelling's workload);
* :func:`karate_club` — Zachary's karate club.
"""

from __future__ import annotations

import numpy as np

from gnn_tpu_torch.graphs.data import Data
from gnn_tpu_torch.graphs.transforms import coalesce, remove_self_loops, to_undirected

__all__ = [
    "stochastic_block_model", "cora_like", "random_regular", "power_law", "clustered_power_law", "karate_club",
]


def stochastic_block_model(
    num_nodes: int = 200,
    num_classes: int = 4,
    *,
    p_in: float = 0.05,
    p_out: float = 0.002,
    feature_dim: int = 16,
    feature_noise: float = 1.0,
    train_frac: float = 0.3,
    val_frac: float = 0.2,
    seed: int = 0,
) -> Data:
    """SBM with class-informative Gaussian features and split masks."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_nodes)
    iu, ju = np.triu_indices(num_nodes, k=1)
    prob = np.where(y[iu] == y[ju], p_in, p_out)
    keep = rng.random(len(iu)) < prob
    ei = np.stack([iu[keep], ju[keep]]).astype(np.int64)
    ei, _ = to_undirected(ei, num_nodes=num_nodes)
    centroids = rng.normal(size=(num_classes, feature_dim)) * 2.0
    x = centroids[y] + feature_noise * rng.normal(size=(num_nodes, feature_dim))
    perm = rng.permutation(num_nodes)
    n_train = int(train_frac * num_nodes)
    n_val = int(val_frac * num_nodes)
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train : n_train + n_val]] = True
    test_mask[perm[n_train + n_val :]] = True
    return Data(
        x=x.astype(np.float32),
        edge_index=ei,
        y=y,
        num_nodes=num_nodes,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
    )


def cora_like(*, seed: int = 0) -> Data:
    """A seeded stand-in for the Planetoid Cora citation graph.

    Degree-weighted (Chung-Lu style) edges with ~0.81 edge homophily, Cora's
    exact class counts, binary bag-of-words features drawn from per-class
    topics with off-topic confusion, and the canonical split (20 train per
    class, 500 val, 1000 test). A 2-layer GCN with Kipf's hyperparameters
    lands in Cora's accuracy band on it.
    """
    rng = np.random.default_rng(seed)
    n, f, c = 2708, 1433, 7
    class_counts = np.array([351, 217, 418, 818, 426, 298, 180])
    y = np.repeat(np.arange(c), class_counts)
    rng.shuffle(y)

    n_pairs, homophily = 5278, 0.755  # lands ~0.81 after dedup/undirect
    w = (1.0 + rng.pareto(2.6, n)).clip(max=45.0)
    order = np.argsort(y, kind="stable")
    by_class = np.split(order, np.cumsum(class_counts)[:-1])
    probs_all = w / w.sum()
    target = int(n_pairs * 1.25)  # oversample; coalesce trims duplicates
    u = rng.choice(n, target, p=probs_all)
    same = rng.random(target) < homophily
    v = np.empty(target, np.int64)
    for k in range(c):
        nodes_k = by_class[k]
        pk = w[nodes_k] / w[nodes_k].sum()
        m = same & (y[u] == k)
        v[m] = rng.choice(nodes_k, int(m.sum()), p=pk)
    v[~same] = rng.choice(n, int((~same).sum()), p=probs_all)
    ei, _ = remove_self_loops(np.stack([u, v]))
    ei, _ = to_undirected(ei, num_nodes=n)
    su, sv = ei[0], ei[1]
    upper = su < sv
    pairs = np.stack([su[upper], sv[upper]])
    keep = rng.permutation(pairs.shape[1])[:n_pairs]
    pairs = pairs[:, np.sort(keep)]
    ei, _ = coalesce(np.concatenate([pairs, pairs[::-1]], axis=1), num_nodes=n)

    words_per_node, topic_size, topic_share, confusion = 18, 160, 0.32, 0.36
    x = np.zeros((n, f), np.float32)
    topics = []
    for k in range(c):
        t = np.zeros(f)
        sel = rng.choice(f, topic_size, replace=False)
        t[sel] = rng.dirichlet(np.full(topic_size, 0.3))
        topics.append(t)
    background = rng.dirichlet(np.full(f, 0.5))
    mixes = [topic_share * topics[k] + (1 - topic_share) * background for k in range(c)]
    for k in range(c):
        for i in by_class[k]:
            kk = rng.integers(0, c) if rng.random() < confusion else k
            nw = max(2, int(rng.normal(words_per_node, 6)))
            x[i, rng.choice(f, min(nw, f), replace=True, p=mixes[kk])] = 1.0

    train_mask = np.zeros(n, bool)
    for k in range(c):
        train_mask[rng.choice(by_class[k], 20, replace=False)] = True
    rest = rng.permutation(np.nonzero(~train_mask)[0])
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    val_mask[rest[:500]] = True
    test_mask[rest[500:1500]] = True
    return Data(
        x=x,
        edge_index=ei,
        y=y,
        num_nodes=n,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
    )


def random_regular(num_nodes: int, degree: int, *, seed: int = 0) -> np.ndarray:
    """Approximately d-regular directed edge list [2, <= N d]: every node
    sends ``degree`` edges to destinations drawn with replacement (self loops
    removed, duplicates coalesced, dst-sorted)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(num_nodes), degree)
    dst = rng.integers(0, num_nodes, num_nodes * degree)
    ei, _ = remove_self_loops(np.stack([src, dst]))
    ei, _ = coalesce(ei, num_nodes=num_nodes)
    return ei


def power_law(
    num_nodes: int,
    num_edges: int,
    *,
    alpha: float = 0.8,
    seed: int = 0,
) -> np.ndarray:
    """Edge list [2, E'] with power-law destination popularity (self loops
    removed, duplicates coalesced, dst-sorted)."""
    rng = np.random.default_rng(seed)
    popularity = np.arange(1, num_nodes + 1, dtype=np.float64) ** (-alpha)
    cdf = np.cumsum(popularity)
    cdf /= cdf[-1]
    src = rng.integers(0, num_nodes, num_edges)
    dst = np.searchsorted(cdf, rng.random(num_edges))
    ei, _ = remove_self_loops(np.stack([src, dst]).astype(np.int64))
    ei, _ = coalesce(ei, num_nodes=num_nodes)
    return ei


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
    """Community-structured edge list [2, E'] in O(E): lognormal community
    sizes (mean ``avg_community``, at least 4); ``intra_frac`` of the edges
    join two nodes of one community (power-law popularity for the
    destination inside it), the rest are :func:`power_law` pairs.
    ``shuffle=True`` scatters the node ids, so the communities are not
    visible in the id order. Self loops removed, duplicates coalesced."""
    rng = np.random.default_rng(seed)
    sizes = []
    total = 0
    while total < num_nodes:
        s = max(4, int(rng.lognormal(np.log(avg_community), 0.6)))
        s = min(s, num_nodes - total)
        sizes.append(s)
        total += s
    starts = np.concatenate([[0], np.cumsum(sizes)])
    n_comm = len(sizes)

    e_intra = int(num_edges * intra_frac)
    sizes_arr = np.asarray(sizes, np.float64)
    comm_of_edge = rng.choice(n_comm, e_intra, p=sizes_arr / sizes_arr.sum())
    lo = starts[comm_of_edge]
    sz = sizes_arr[comm_of_edge]
    u = rng.random(e_intra) ** (1.0 / max(1.0 - alpha, 1e-3))
    src_i = lo + (rng.random(e_intra) * sz).astype(np.int64)
    dst_i = lo + (u * sz).astype(np.int64).clip(0, (sz - 1).astype(np.int64))

    inter = power_law(num_nodes, num_edges - e_intra, alpha=alpha, seed=seed + 1)
    ei = np.concatenate([np.stack([src_i, dst_i]), np.asarray(inter, np.int64)], axis=1)
    if shuffle:
        ei = rng.permutation(num_nodes)[ei]
    ei, _ = remove_self_loops(ei)
    ei, _ = coalesce(ei, num_nodes=num_nodes)
    return ei


def karate_club() -> Data:
    """Zachary's karate club (34 nodes, 78 undirected edges, 2 factions)."""
    edges = [
        (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
        (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
        (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19),
        (1, 21), (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13),
        (2, 27), (2, 28), (2, 32), (3, 7), (3, 12), (3, 13), (4, 6),
        (4, 10), (5, 6), (5, 10), (5, 16), (6, 16), (8, 30), (8, 32),
        (8, 33), (9, 33), (13, 33), (14, 32), (14, 33), (15, 32),
        (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
        (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32),
        (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
        (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33),
        (30, 32), (30, 33), (31, 32), (31, 33), (32, 33),
    ]
    labels = np.array(
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0,
         1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.int64
    )
    ei, _ = to_undirected(np.array(edges, np.int64).T, num_nodes=34)
    return Data(x=np.eye(34, dtype=np.float32), edge_index=ei, y=labels, num_nodes=34)
