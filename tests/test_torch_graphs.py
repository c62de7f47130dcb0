"""The port's graph prep (gnn_tpu_torch.graphs) against gnn_tpu.graphs.

Same numpy inputs into both packages; integer arrays must be identical and
float weights equal to rtol=1e-6 (the JAX package sums degrees from float32
weights in its native core, the port from float64 ones).
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jg
from gnn_tpu.graphs import generate as jgen
from gnn_tpu_torch import graphs as tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same_data(jd, td):
    assert jd.num_nodes == td.num_nodes
    for name in ("x", "edge_index", "y", "train_mask", "val_mask", "test_mask"):
        ja, ta = getattr(jd, name), getattr(td, name)
        assert (ja is None) == (ta is None), name
        if ja is not None:
            np.testing.assert_array_equal(_np(ta), np.asarray(ja), err_msg=name)


@pytest.mark.parametrize(
    "make_jax,make_torch",
    [
        (lambda: jgen.stochastic_block_model(300, 3, seed=7),
         lambda: tg.stochastic_block_model(300, 3, seed=7)),
        (lambda: jgen.cora_like(seed=0), lambda: tg.cora_like(seed=0)),
        (jgen.karate_club, tg.karate_club),
        (lambda: jg.Data(edge_index=jgen.clustered_power_law(3000, 20000, avg_community=60, seed=4),
                         num_nodes=3000),
         lambda: tg.Data(edge_index=tg.clustered_power_law(3000, 20000, avg_community=60, seed=4),
                         num_nodes=3000)),
    ],
    ids=["sbm", "cora_like", "karate", "clustered_power_law"],
)
def test_generators_identical(make_jax, make_torch):
    _assert_same_data(make_jax(), make_torch())


def test_power_law_identical():
    np.testing.assert_array_equal(
        tg.power_law(5000, 40000, alpha=0.8, seed=3),
        jgen.power_law(5000, 40000, alpha=0.8, seed=3),
    )


@pytest.mark.parametrize("name", ["karate", "sbm"])
def test_load_dataset_builtins_identical(name):
    from gnn_tpu.graphs.datasets import load_dataset

    _assert_same_data(load_dataset(name), tg.load_dataset(name))


def _random_edges(rng, n=300, e=2500):
    # duplicates and self loops on purpose
    return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64), n


def test_transforms_match(rng):
    ei, n = _random_edges(rng)
    w = rng.uniform(0.1, 2.0, ei.shape[1])
    pairs = [
        (jg.remove_self_loops(ei, w), tg.remove_self_loops(ei, w)),
        (jg.add_remaining_self_loops(ei, w, 2.0, n), tg.add_remaining_self_loops(ei, w, 2.0, n)),
        (jg.to_undirected(ei, w, n), tg.to_undirected(ei, w, n)),
        (jg.to_undirected(ei, num_nodes=n), tg.to_undirected(ei, num_nodes=n)),
    ]
    for reduce in ("sum", "max", "mean"):
        pairs.append((jg.coalesce(ei, w, n, reduce), tg.coalesce(ei, w, n, reduce)))
    for (je, jw), (te, tw) in pairs:
        np.testing.assert_array_equal(te, je)
        assert (jw is None) == (tw is None)
        if jw is not None:
            np.testing.assert_allclose(tw, jw, rtol=1e-12)


def test_degree_matches(rng):
    ei, n = _random_edges(rng)
    w = rng.uniform(0.1, 2.0, ei.shape[1]).astype(np.float32)
    for kind in ("in", "out"):
        np.testing.assert_array_equal(tg.degree(ei, n, kind=kind), jg.degree(ei, n, kind=kind))
        np.testing.assert_allclose(
            tg.degree(ei, n, w, kind=kind), jg.degree(ei, n, w, kind=kind), rtol=1e-6
        )


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(improved=True),
        dict(norm="rw"),
        dict(self_loops=False),
        dict(weighted=True),
    ],
    ids=["sym", "improved", "rw", "no_loops", "weighted"],
)
def test_gcn_norm_matches(rng, kwargs):
    kwargs = dict(kwargs)
    ei, n = _random_edges(rng)
    ei, _ = jg.to_undirected(ei, num_nodes=n)
    w = rng.uniform(0.1, 2.0, ei.shape[1]) if kwargs.pop("weighted", False) else None
    je, jw = jg.gcn_norm(ei, w, n, **kwargs)
    te, tw = tg.gcn_norm(ei, w, n, **kwargs)
    np.testing.assert_array_equal(te, je)
    assert tw.dtype == np.float32
    np.testing.assert_allclose(tw, jw, rtol=1e-6)


@pytest.mark.parametrize("square", [True, False], ids=["square", "rectangular"])
def test_build_adjacency_identical(rng, square):
    ei, n = _random_edges(rng)
    w = rng.normal(size=ei.shape[1]).astype(np.float32)
    if square:
        kw = dict(num_nodes=n)
    else:
        ei[1] %= n // 2
        kw = dict(num_src_nodes=n, num_dst_nodes=n // 2)
    ja = jg.build_adjacency(ei, jnp.asarray(w), layout="csr", **kw)
    ta = tg.build_adjacency(ei, w, **kw)
    for name in ("src", "dst", "row_ptr", "t_perm", "t_row_ptr"):
        got = getattr(ta, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ja, name)), err_msg=name)
    np.testing.assert_array_equal(ta.weight.numpy(), np.asarray(ja.weight))
    jt = ja.transpose()
    np.testing.assert_array_equal(ta.t_col.numpy(), np.asarray(jt.src))
    np.testing.assert_array_equal(ta.t_weight.numpy(), np.asarray(jt.weight))
    assert (ta.num_src_nodes, ta.num_dst_nodes) == (ja.num_src_nodes, ja.num_dst_nodes)


def test_data_to_adjacency_matches(rng):
    jd = jgen.stochastic_block_model(250, 4, seed=2)
    td = tg.stochastic_block_model(250, 4, seed=2)
    ja = jd.to_adjacency(norm="sym", layout="csr")
    ta = td.to_adjacency(norm="sym")
    for name in ("src", "dst", "row_ptr", "t_perm", "t_row_ptr"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)))
    np.testing.assert_allclose(ta.weight.numpy(), np.asarray(ja.weight), rtol=1e-6)
    moved = ta.to("cpu")
    assert moved.num_edges == ta.num_edges and moved.device.type == "cpu"


def test_unported_options_raise(rng, tmp_path):
    """The relabelling and the layouts are ported (ROADMAP item 9): the
    options take the JAX package's values and raise its errors."""
    ei, n = _random_edges(rng)
    for kwargs in (dict(reorder=True), dict(layout="bogus"), dict(layout="ell", ell_buckets=())):
        with pytest.raises(ValueError) as want:
            jg.build_adjacency(ei, num_nodes=n, **kwargs)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tg.build_adjacency(ei, num_nodes=n, **kwargs)
    assert tg.build_adjacency(ei, num_nodes=n, layout="ell").layout == "ell"
    # the file loaders are ported (local files only): without the files they
    # name the layout they expect, as the JAX package's do
    for name, layout in (("cora", "ind.cora"), ("ogbn-arxiv", "standard OGB extracted layout")):
        with pytest.raises(FileNotFoundError, match=layout):
            tg.load_dataset(name, str(tmp_path))


def test_data_checks_and_npz_round_trip(tmp_path):
    with pytest.raises(ValueError, match="num_nodes"):
        tg.Data(edge_index=np.array([[0, 5], [1, 2]]), num_nodes=3)
    d = tg.stochastic_block_model(60, 3, seed=1)
    path = tmp_path / "g.npz"
    np.savez(
        path, x=d.x.numpy(), edge_index=d.edge_index.numpy(), y=d.y.numpy(),
        train_mask=d.train_mask.numpy(), val_mask=d.val_mask.numpy(), test_mask=d.test_mask.numpy(),
    )
    _assert_same_data(d, tg.load_dataset(str(path)))


def test_port_imports_without_jax():
    code = (
        "import sys, gnn_tpu_torch, gnn_tpu_torch.train.cli, gnn_tpu_torch.ops.cuda, "
        "gnn_tpu_torch.ops.cuda.spmm_heads, gnn_tpu_torch.ops.cuda.bounds, gnn_tpu_torch.ops.gather, "
        "gnn_tpu_torch.mp.gat, "
        "gnn_tpu_torch.models.gat, gnn_tpu_torch.native, gnn_tpu_torch.graphs.blocked; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert not any(m.startswith('gnn_tpu.') or m == 'gnn_tpu' for m in sys.modules)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
