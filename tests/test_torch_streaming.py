"""``graphs/streaming.py`` (host-streamed chunks, one K1 launch a chunk)
against gnn_tpu's ``graphs/streaming.py`` on the same numpy inputs.

Host arrays (``chunks``, ``chunks_rle``, ``chunks_packed``, ``range_rows``)
and every error: exact. The streamed products and gradients: rtol=1e-5,
atol=1e-5 (float32; the port sums each chunk's rows in K1's order, the JAX
package in XLA's segment sum). Against the resident CSR product (K1's plain
version over the whole graph): the same tolerance, since a destination cut
by a chunk boundary is summed in two partials.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import streaming as js
from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch.graphs import streaming as ts
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain

TOL = dict(rtol=1e-5, atol=1e-5)
N, E, CHUNK = 300, 5000, 1024


@pytest.fixture(scope="module")
def edges():
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    return ei, rng.random(E).astype(np.float32), rng.random(N).astype(np.float32)


def _streams(ei, w, **kw):
    kw.setdefault("chunk_edges", CHUNK)
    return js.EdgeStream(ei, w, num_nodes=N, **kw), ts.EdgeStream(ei, w, num_nodes=N, **kw)


@pytest.mark.parametrize(
    "weighted,kw",
    [(False, {}), (True, {}), (False, dict(min_range_rows=100)), (True, dict(chunk_edges=700)),
     (False, dict(chunk_edges=8192))],
    ids=["unweighted", "weighted", "min-range-rows", "weighted-ragged", "one-chunk"],
)
def test_host_chunks_equal_jax(edges, weighted, kw):
    ei, w, _ = edges
    jsm, tsm = _streams(ei, w if weighted else None, **kw)
    assert (tsm.range_rows, tsm.num_chunks, tsm.num_edges) == (jsm.range_rows, jsm.num_chunks, jsm.num_edges)
    np.testing.assert_array_equal(tsm.src, jsm.src)
    for a, b in zip(jsm.chunks(), tsm.chunks(), strict=True):
        for p, q in zip(a[:3], b[:3]):
            assert (p is None) == (q is None)
            if p is not None:
                np.testing.assert_array_equal(q, p)
        assert a[3] == b[3]
    for a, b in zip(jsm.chunks_rle(), tsm.chunks_rle(), strict=True):
        np.testing.assert_array_equal(b[1], a[1])
    for a, b in zip(jsm.chunks_packed(), tsm.chunks_packed(), strict=True):
        assert b[0].dtype == np.int32 and len(b[0]) == tsm.packed_len
        np.testing.assert_array_equal(b[0], a[0])
        assert a[1] == b[1]
    t_j, t_t = jsm.transpose(), tsm.transpose()
    np.testing.assert_array_equal(t_t.src, t_j.src)
    assert t_t.range_rows == t_j.range_rows


def test_assume_sorted_and_checks_equal_jax(edges):
    ei, w, _ = edges
    order = np.argsort(ei[1], kind="stable")
    sorted_ei = ei[:, order]
    jsm = js.EdgeStream(sorted_ei, w[order], num_nodes=N, chunk_edges=CHUNK, assume_sorted=True)
    tsm = ts.EdgeStream(sorted_ei, w[order], num_nodes=N, chunk_edges=CHUNK, assume_sorted=True)
    for a, b in zip(jsm.chunks_packed(), tsm.chunks_packed(), strict=True):
        np.testing.assert_array_equal(b[0], a[0])
    for kw, args in ((dict(assume_sorted=True), (ei,)), (dict(), (ei[:, :10],))):
        num_nodes = N if kw else 2**31
        with pytest.raises(ValueError) as want:
            js.EdgeStream(*args, num_nodes=num_nodes, **kw)
        with pytest.raises(ValueError, match=str(want.value).split(" —")[0]):
            ts.EdgeStream(*args, num_nodes=num_nodes, **kw)


@pytest.mark.parametrize("mode", ["unweighted", "weighted", "norm"])
def test_streaming_spmm_matches_jax_and_resident_k1(edges, mode):
    """Five chunks of 1,024 edges, destinations cut at every boundary."""
    ei, w, norm = edges
    jsm, tsm = _streams(ei, w if mode == "weighted" else None)
    cut = [tsm.dst[c * CHUNK - 1] == tsm.dst[c * CHUNK] for c in range(1, tsm.num_chunks)]
    assert any(cut)
    x = np.random.default_rng(1).normal(size=(N, 16)).astype(np.float32)
    jn, tn = (jnp.asarray(norm), torch.from_numpy(norm)) if mode == "norm" else (None, None)
    want = np.asarray(js.streaming_spmm(jsm, jnp.asarray(x), norm=jn))
    stats = {}
    got = ts.streaming_spmm(tsm, torch.from_numpy(x), norm=tn, stats=stats)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, ts.streaming_spmm(tsm, torch.from_numpy(x), norm=tn))
    assert (stats["chunks"], stats["edges"], stats["h2d_bytes"]) == (5, E, 5 * 4 * tsm.packed_len)
    # the resident CSR product over the same edges
    adj = tg.build_adjacency(ei, None if mode == "unweighted" else w, num_nodes=N)
    if mode == "norm":
        adj = adj.with_weight(torch.from_numpy(norm[adj.src.numpy()] * norm[adj.dst.numpy()]))
    resident = csr_spmm_plain(adj.row_ptr, adj.src, adj.weight, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), resident.numpy(), **TOL)


def test_streaming_spmm_grad_matches_jax(edges):
    ei, _, norm = edges
    jsm, tsm = _streams(ei, None)
    x = np.random.default_rng(2).normal(size=(N, 8)).astype(np.float32)
    ct = np.random.default_rng(3).normal(size=(N, 8)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda v: js.streaming_spmm_grad(jsm, jsm.transpose(), v, norm=jnp.asarray(norm)),
                         jnp.asarray(x))
    (j_dx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    out = ts.streaming_spmm_grad(tsm, tsm.transpose(), xt, norm=torch.from_numpy(norm))
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **TOL)


@pytest.mark.parametrize(
    "chunk_edges,backend,baked",
    [(1000, "rank", False), (1024, "rank", False), (1024, "bogus", False), (1024, "auto", True)],
    ids=["rank-untiled", "rank-tiled", "unknown", "weights-and-norm"],
)
def test_streaming_spmm_errors_equal_jax(edges, chunk_edges, backend, baked):
    """'rank' raises where the JAX rank reduction cannot tile the chunk;
    every accepted backend runs K1 and gives the same result."""
    ei, w, norm = edges
    jsm, tsm = _streams(ei, w if baked else None, chunk_edges=chunk_edges)
    x = np.zeros((N, 4), np.float32)
    norm_args = (jnp.asarray(norm), torch.from_numpy(norm)) if baked else (None, None)
    try:
        js.streaming_spmm(jsm, jnp.asarray(x), norm=norm_args[0], segment_backend=backend)
    except ValueError as want:
        with pytest.raises(ValueError, match=str(want)):
            ts.streaming_spmm(tsm, torch.from_numpy(x), norm=norm_args[1], segment_backend=backend)
    else:
        ts.streaming_spmm(tsm, torch.from_numpy(x), norm=norm_args[1], segment_backend=backend)


def test_streaming_spmm_launches_nothing_on_the_cpu(edges):
    ei, w, _ = edges
    _, tsm = _streams(ei, w)
    before = csr_spmm.launches
    ts.streaming_spmm(tsm, torch.ones(N, 4))
    assert csr_spmm.launches == before


@pytest.mark.parametrize(
    "shape,dtype", [((1000, 7), np.float32), ((333,), np.int32), ((), np.float64), ((0, 3), np.float32)]
)
def test_device_put_slabbed_round_trips(shape, dtype, tmp_path):
    """Slabs of 1,000 bytes (several a row range) into one tensor, from an
    array and from a memmap."""
    arr = np.random.default_rng(4).normal(size=shape).astype(dtype)
    got = ts.device_put_slabbed(arr, slab_bytes=1000, device="cpu")
    assert got.shape == arr.shape and got.numpy().dtype == arr.dtype
    np.testing.assert_array_equal(got.numpy(), arr)
    if arr.ndim:
        path = tmp_path / "a.npy"
        np.save(path, arr)
        np.testing.assert_array_equal(
            ts.device_put_slabbed(np.load(path, mmap_mode="r"), slab_bytes=1000, device="cpu").numpy(), arr
        )


def test_dist_edge_stream_waits_for_item_15(edges):
    """Ported (the name is from before): DistEdgeStream constructs with the
    JAX geometry, and over 2 parts of the CPU its spmm_host equals the
    single-device streaming_spmm. More: tests/test_torch_dist_stream.py."""
    from gnn_tpu_torch.parallel import make_mesh

    ei, w, _ = edges
    want = js.DistEdgeStream(ei, w, num_nodes=N, num_parts=2, chunk_edges=CHUNK)
    got = ts.DistEdgeStream(ei, w, num_nodes=N, num_parts=2, chunk_edges=CHUNK)
    for key in ("n_max", "range_rows", "num_chunks", "u_sizes", "u_max", "has_weight"):
        assert getattr(got, key) == getattr(want, key), key
    x = np.random.default_rng(3).normal(size=(N, 6)).astype(np.float32)
    out = got.spmm_host(x, make_mesh((2,), ("data",), devices=["cpu"] * 2))
    single = ts.streaming_spmm(ts.EdgeStream(ei, w, num_nodes=N, chunk_edges=CHUNK), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), single.numpy(), **TOL)
