"""``graphs/streaming.py::DistEdgeStream`` (each part streams the in-edges
of its destinations with the unique source rows of each chunk gathered on
the host; one K1 launch a chunk for all the parts of a process) against
``gnn_tpu.graphs.streaming.DistEdgeStream``.

Geometry (``n_max``, ``range_rows``, ``num_chunks``, ``u_sizes``, ``u_max``,
``rank_h``, ``rank_k`` and each part's ``src`` / ``dst`` / ``weight``):
exact, for weighted and unweighted graphs, an uneven node count, every
destination in part 0 (``tests/test_streaming.py:222-240``) and P 2 / 4 / 8;
only numpy runs. ``spmm_host``: against the JAX ``spmm_host`` on the
8-device CPU mesh for one weighted and one unweighted case (its per-chunk
jit, ~1 s), and for every case against the dense oracle and the port's
``spmm_dist`` over the same partition; rtol 1e-4 / atol 1e-5 (float32 sums
in another order)."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from gnn_tpu.graphs.streaming import DistEdgeStream as JaxDistEdgeStream
from gnn_tpu.parallel import make_mesh as jax_make_mesh
from gnn_tpu_torch.graphs.streaming import DistEdgeStream
from gnn_tpu_torch.parallel import make_mesh, multihost, partition_graph, shard_node_array, spmm_dist

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
CASES = {
    "weighted-P2": dict(P=2, weighted=True),
    "unweighted-P4": dict(P=4, weighted=False),
    "weighted-P8": dict(P=8, weighted=True),
    "uneven-N-P4": dict(P=4, weighted=True, n=251),
    "one-part-P4": dict(P=4, weighted=False, skew=True),
    "rank-geometry-P2": dict(P=2, weighted=True, chunk=1024),
    "unweighted-P8": dict(P=8, weighted=False),
}


def _case(name):
    c = CASES[name]
    n, e = c.get("n", 240), 4000
    rng = np.random.default_rng(len(name))
    # "one-part": every destination in part 0's range, the other parts stream nothing
    hi = -(-n // c["P"]) if c.get("skew") else n
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, hi, e)])
    w = rng.uniform(0.1, 1.0, e).astype(np.float32) if c["weighted"] else None
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return ei, w, x, n, c["P"], c.get("chunk", 256)


def _dense(ei, w, n, x):
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (ei[1], ei[0]), 1.0 if w is None else w)
    return a @ x


@pytest.mark.parametrize("name", list(CASES))
def test_geometry_equals_jax(name):
    ei, w, _, n, P, chunk = _case(name)
    want = JaxDistEdgeStream(ei, w, num_nodes=n, num_parts=P, chunk_edges=chunk)
    got = DistEdgeStream(ei, w, num_nodes=n, num_parts=P, chunk_edges=chunk)
    for key in ("num_parts", "num_nodes", "num_edges", "chunk_edges", "n_max", "range_rows", "num_chunks",
                "has_weight", "u_sizes", "u_max", "rank_h", "rank_k"):
        assert getattr(got, key) == getattr(want, key), key
    assert len(got.streams) == len(want.streams) == P
    for a, b in zip(want.streams, got.streams):
        np.testing.assert_array_equal(b.src, a.src)
        np.testing.assert_array_equal(b.dst, a.dst)
        assert (a.weight is None) == (b.weight is None)
        if a.weight is not None:
            np.testing.assert_array_equal(b.weight, a.weight)
        assert (b.range_rows, b.num_chunks) == (a.range_rows, a.num_chunks)
    for p, s in enumerate(got.streams):
        for c in range(s.num_chunks):
            uniq, slots = got._chunk_uniq(p, c)
            want_uniq, want_inv = want._chunk_uniq(p, c)
            np.testing.assert_array_equal(uniq, want_uniq)
            np.testing.assert_array_equal(slots, want_inv[: len(slots)])


@pytest.mark.parametrize("name", list(CASES))
def test_spmm_host_equals_the_dense_oracle_and_spmm_dist(name):
    ei, w, x, n, P, chunk = _case(name)
    stream = DistEdgeStream(ei, w, num_nodes=n, num_parts=P, chunk_edges=chunk)
    mesh = make_mesh((P,), ("data",), devices=[CPU] * P)
    stats = {}
    got = stream.spmm_host(x, mesh, stats=stats)
    assert got.shape == (n, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _dense(ei, w, n, x), **TOL)
    dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="alltoall")
    assert dist.n_max == stream.n_max
    want = dist.unshard_nodes(spmm_dist(dist, shard_node_array(dist, x, mesh)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # one K1 launch a chunk for all the parts, and only the chunk's unique rows shipped
    assert stats["chunks"] == stream.num_chunks and stats["edges"] == ei.shape[1]
    assert stats["rows_shipped"] == sum(map(sum, stream.u_sizes))


@pytest.mark.parametrize("name", ["weighted-P8", "unweighted-P8"])
def test_spmm_host_equals_jax(name):
    ei, w, x, n, P, chunk = _case(name)
    jmesh = jax_make_mesh((P,), ("data",), devices=jax.devices()[:P])
    want = np.asarray(JaxDistEdgeStream(ei, w, num_nodes=n, num_parts=P, chunk_edges=chunk).spmm_host(x, jmesh))
    got = DistEdgeStream(ei, w, num_nodes=n, num_parts=P, chunk_edges=chunk).spmm_host(
        x, make_mesh((P,), ("data",), devices=[CPU] * P))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spmm_host_reads_a_memmap_and_checks_its_arguments(tmp_path):
    ei, w, x, n, P, chunk = _case("weighted-P2")
    np.save(tmp_path / "x.npy", x)
    stream = DistEdgeStream(ei, w, num_nodes=n, num_parts=P, chunk_edges=chunk)
    mesh = make_mesh((P,), ("data",), devices=[CPU] * P)
    got = stream.spmm_host(np.load(tmp_path / "x.npy", mmap_mode="r"), mesh)
    np.testing.assert_allclose(got.numpy(), _dense(ei, w, n, x), **TOL)
    with pytest.raises(ValueError, match="float32"):
        stream.spmm_host(x.astype(np.float64), mesh)
    with pytest.raises(ValueError, match=r"\[240, F\]"):
        stream.spmm_host(x[:10], mesh)
    with pytest.raises(ValueError, match="4 parts"):
        stream.spmm_host(x, make_mesh((4,), ("data",), devices=[CPU] * 4))


def test_spmm_host_in_a_group_returns_the_partition_layout(tmp_path):
    """In a gloo group of one process the result is this process's rows in
    the padded layout of the partition, ``[L n_max, F]``."""
    ei, w, x, n, P, chunk = _case("uneven-N-P4")
    stream = DistEdgeStream(ei, w, num_nodes=n, num_parts=P, chunk_edges=chunk)
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        mesh = make_mesh((P,), ("data",), devices=[CPU] * P)
        got = stream.spmm_host(x, mesh)
        dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="alltoall")
        assert mesh.grouped and got.shape == (P * stream.n_max, 8)
        np.testing.assert_allclose(dist.unshard_nodes(got).numpy(), _dense(ei, w, n, x), **TOL)
        assert not got[n:].any()  # the padding rows
    finally:
        tdist.destroy_process_group()
