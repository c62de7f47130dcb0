"""The small gaps in the port's ``graphs`` and ``ops``: the converters,
``random_regular``, ``Data.set_mask`` / ``to_dense_adj``, ``spmm_coo`` and the
Planetoid / OGB file loaders, against gnn_tpu on the same numpy inputs.

Integer outputs are compared exactly (the port's edge lists are int64 where
the JAX package's are int32: values, not dtypes, are held). ``spmm_coo``:
values and gradients at rtol=1e-5, atol=1e-6 (float32 sums in another order).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jgraphs
from gnn_tpu import ops as jops
from gnn_tpu.graphs import datasets as jdatasets
from gnn_tpu.graphs.generate import random_regular as jax_random_regular
from gnn_tpu_torch import graphs as tgraphs
from gnn_tpu_torch import native as tnative
from gnn_tpu_torch import ops as tops
from gnn_tpu_torch import train as ttrain
from gnn_tpu_torch.graphs import TEST, TRAIN, VAL, Data, datasets, random_regular

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def edges(rng):
    """A directed list with duplicate edges and node 11 isolated."""
    return np.stack([rng.integers(0, 11, 40), rng.integers(0, 11, 40)]), 12


def test_edge_list_equals_jax():
    got = tgraphs.edge_list([0, 2, 5], [1, 1, 3])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgraphs.edge_list([0, 2, 5], [1, 1, 3])))
    with pytest.raises(ValueError, match="equal length"):
        tgraphs.edge_list([0, 1], [1])


@pytest.mark.parametrize("weighted", [False, True])
def test_dense_round_trip_equals_jax(edges, rng, weighted):
    ei, n = edges
    w = rng.random(ei.shape[1]).astype(np.float32) if weighted else None
    dense = tgraphs.to_dense_adj(ei, w, n)
    assert dense.dtype == torch.float32 and tuple(dense.shape) == (n, n)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jgraphs.to_dense_adj(ei, w, n)))
    assert dense[ei[1, 0], ei[0, 0]] > 0  # A[dst, src]
    assert tuple(tgraphs.to_dense_adj(ei).shape) == (int(ei.max()) + 1,) * 2
    back, attr = tgraphs.dense_to_edge_list(dense)
    jback, jattr = jgraphs.dense_to_edge_list(np.asarray(dense))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    np.testing.assert_array_equal(attr.numpy(), np.asarray(jattr))
    np.testing.assert_array_equal(tgraphs.to_dense_adj(back, attr, n).numpy(), dense.numpy())


def test_csr_round_trip_equals_jax(edges):
    ei, n = edges
    got, want = tgraphs.edge_list_to_csr(ei, n), jgraphs.edge_list_to_csr(ei, n)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    row_ptr, col, order = got
    assert row_ptr[-1] == ei.shape[1] and len(row_ptr) == n + 1
    back = tgraphs.csr_to_edge_list(row_ptr, col)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jgraphs.csr_to_edge_list(row_ptr, col)))
    np.testing.assert_array_equal(back.numpy(), ei[:, order])
    # a tensor edge list converts as the array does
    np.testing.assert_array_equal(tgraphs.edge_list_to_csr(torch.from_numpy(ei), n)[0], row_ptr)


@pytest.mark.parametrize("n,degree,seed", [(50, 3, 0), (200, 8, 4)])
def test_random_regular_equals_jax(n, degree, seed):
    got = random_regular(n, degree, seed=seed)
    np.testing.assert_array_equal(got, jax_random_regular(n, degree, seed=seed))
    assert got.shape[1] <= n * degree and (got[0] != got[1]).all()


def test_set_mask_and_to_dense_adj_on_data(edges, rng):
    ei, n = edges
    attr = rng.random(ei.shape[1]).astype(np.float32)
    jd = jgraphs.Data(edge_index=ei, edge_attr=attr, num_nodes=n)
    for host in (False, True):
        d = Data(edge_index=ei, edge_attr=attr, num_nodes=n, host_arrays=host)
        assert (TRAIN, VAL, TEST) == (jgraphs.TRAIN, jgraphs.VAL, jgraphs.TEST) == ("train", "val", "test")
        mask = np.arange(n) % 3 == 0
        for split in (TRAIN, VAL, TEST):
            out = d.set_mask(mask.astype(np.int64), split)
            got = getattr(out, f"{split}_mask")
            assert got.dtype == (bool if host else torch.bool) and getattr(d, f"{split}_mask") is None
            np.testing.assert_array_equal(np.asarray(got), np.asarray(getattr(jd.set_mask(mask, split), f"{split}_mask")))
        with pytest.raises(ValueError, match="split must be one of"):
            d.set_mask(mask, "holdout")
        with pytest.raises(ValueError, match="entries"):
            d.set_mask(mask[:-1], TRAIN)
        np.testing.assert_array_equal(d.to_dense_adj().numpy(), np.asarray(jd.to_dense_adj()))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("is_sorted", [False, True])
def test_spmm_coo_matches_jax(edges, rng, weighted, is_sorted):
    ei, n = edges
    if is_sorted:
        ei = ei[:, np.argsort(ei[1], kind="stable")]
    x = rng.normal(size=(n, 5)).astype(np.float32)
    w = rng.random(ei.shape[1]).astype(np.float32) if weighted else None
    ct = rng.normal(size=(n, 5)).astype(np.float32)

    def jax_loss(x, w):
        out = jops.spmm_coo(jnp.asarray(ei[0]), jnp.asarray(ei[1]), x, n, w, indices_are_sorted=is_sorted)
        return jnp.sum(out * ct), out

    argnums = (0, 1) if weighted else (0,)
    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=argnums, has_aux=True)(
        jnp.asarray(x), None if w is None else jnp.asarray(w)
    )
    tx = torch.from_numpy(x).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    out = tops.spmm_coo(torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), tx, n, tw, indices_are_sorted=is_sorted)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_grads[0]), **TOL)
    if weighted:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_grads[1]), **TOL)
    dense = tgraphs.to_dense_adj(ei, w, n)
    np.testing.assert_allclose(out.detach().numpy(), (dense @ torch.from_numpy(x)).numpy(), **TOL)
    with pytest.raises(ValueError, match="rank 2"):
        tops.spmm_coo(torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), tx[0], n)


def _write_planetoid(root, name, n_allx=8, test_ids=(8, 9, 10, 11), f=6, c=3):
    """A synthetic graph in the ind.* pickle layout: tx[i] / ty[i] belong to
    the node that line i of the shuffled index file names (row i of the final
    graph is i * ones)."""
    raw = os.path.join(root, name, "raw")
    os.makedirs(raw)
    test_ids = np.asarray(test_ids)
    n = int(test_ids.max()) + 1
    final_x = np.arange(n)[:, None] * np.ones((1, f), np.float32)
    final_y = np.eye(c, dtype=np.int64)[np.arange(n) % c]
    shuffled = np.random.default_rng(0).permutation(test_ids)
    objs = {
        "x": final_x[:3], "tx": final_x[shuffled], "allx": final_x[:n_allx],
        "y": final_y[:3], "ty": final_y[shuffled], "ally": final_y[:n_allx],
        "graph": {i: [int((i + 1) % n)] for i in range(n)},
    }
    for k, obj in objs.items():
        with open(os.path.join(raw, f"ind.{name}.{k}"), "wb") as fh:
            pickle.dump(obj, fh)
    np.savetxt(os.path.join(raw, f"ind.{name}.test.index"), shuffled, fmt="%d")
    return n, final_x


def _same_data(t, j):
    assert (t.num_nodes, t.num_edges, t.num_features) == (j.num_nodes, j.num_edges, j.num_features)
    for name in ("x", "edge_index", "y", "train_mask", "val_mask", "test_mask"):
        got, want = getattr(t, name), getattr(j, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize(
    "name,test_ids", [("cora", (8, 9, 10, 11)), ("citeseer", (8, 9, 10, 11)), ("citeseer", (8, 10, 11, 13))],
    ids=["cora", "citeseer", "citeseer-gaps"],
)
def test_load_planetoid_equals_jax_on_a_fixture(tmp_path, name, test_ids):
    """Where citeseer's test ids have gaps the missing nodes get zero rows;
    the JAX loader fails on such a file (it reorders over the widened id
    range), so there the port is held to the file's own content."""
    n, final_x = _write_planetoid(str(tmp_path), name, test_ids=test_ids)
    t = datasets.load_planetoid(name, str(tmp_path))
    if test_ids == (8, 10, 11, 13):
        with pytest.raises(ValueError, match="shape mismatch"):
            jdatasets.load_planetoid(name, str(tmp_path))
        assert not t.x[[9, 12]].any() and not t.test_mask[[9, 12]].any()
    else:
        _same_data(t, jdatasets.load_planetoid(name, str(tmp_path)))
    np.testing.assert_array_equal(t.x[list(test_ids)].numpy(), final_x[list(test_ids)])
    np.testing.assert_array_equal(t.y[list(test_ids)].numpy(), np.asarray(test_ids) % 3)
    assert int(t.test_mask.sum()) == 4 and t.num_edges == 2 * n and t.y.dtype == torch.int64
    _same_data(datasets.load_dataset(name, str(tmp_path)), t)
    with pytest.raises(FileNotFoundError, match="raw files not found"):
        datasets.load_planetoid("pubmed", str(tmp_path))


@pytest.mark.parametrize("raw_format", ["npz", "csv"])
def test_load_ogbn_equals_jax_on_a_fixture(tmp_path, rng, raw_format):
    pd = pytest.importorskip("pandas")
    base = tmp_path / "ogbn_toy" / "raw"
    base.mkdir(parents=True)
    n, e, f = 20, 50, 4
    x = rng.normal(size=(n, f)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    y = rng.integers(0, 5, (n, 1))
    if raw_format == "npz":
        np.savez(str(base / "data.npz"), node_feat=x, edge_index=ei, node_label=y)
    else:
        for fname, arr in (("node-feat", x), ("edge", ei.T), ("node-label", y)):
            pd.DataFrame(arr).to_csv(str(base / f"{fname}.csv.gz"), index=False, header=False, compression="gzip")
    split = tmp_path / "ogbn_toy" / "split" / "time"
    split.mkdir(parents=True)
    for part, ids in (("train", range(0, 10)), ("valid", range(10, 15)), ("test", range(15, 20))):
        pd.DataFrame(list(ids)).to_csv(str(split / f"{part}.csv.gz"), index=False, header=False, compression="gzip")
    t = datasets.load_ogbn("ogbn-toy", str(tmp_path))
    _same_data(t, jdatasets.load_ogbn("ogbn-toy", str(tmp_path)))
    assert [int(m.sum()) for m in (t.train_mask, t.val_mask, t.test_mask)] == [10, 5, 5]
    assert tuple(t.y.shape) == (n,) and t.y.dtype == torch.int64
    _same_data(datasets.load_dataset("ogbn-toy", str(tmp_path)), t)


def test_file_datasets_that_are_missing_name_their_layout(tmp_path):
    with pytest.raises(FileNotFoundError, match="standard OGB extracted layout"):
        datasets.load_dataset("ogbn-arxiv", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=r"ind\.cora"):
        datasets.load_dataset("cora", str(tmp_path))
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.load_dataset("not-a-dataset")


def test_new_names_are_exported_as_in_the_jax_package():
    """Every name of the JAX package's ``graphs``, ``train`` and ``ops``
    ``__all__`` is exported by the port, and of ``native``'s all but the
    two partitioners of the multi-device item."""
    from gnn_tpu import native as jnative
    from gnn_tpu import train as jtrain

    assert set(jgraphs.__all__) <= set(tgraphs.__all__)
    assert set(jtrain.__all__) <= set(ttrain.__all__)
    assert set(jops.__all__) <= set(tops.__all__)
    assert set(jnative.__all__) - set(tnative.__all__) == {"available", "partition_by_edges", "louvain_cluster"}
    assert {"NeighborSampler", "sample_neighbors", "random_regular"} <= set(tgraphs.__all__)
    assert {"Checkpointer", "HostBatchLoader"} <= set(ttrain.__all__)
    for module in (tgraphs, ttrain, tops, tnative):
        assert all(hasattr(module, name) for name in module.__all__)
