"""The port's community relabelling against gnn_tpu: the native graph
core, the packing and refinement orders, ``build_adjacency(reorder='cluster')``,
``spmm`` over such an adjacency (K1 over its CSR) against the JAX package's
blocked product and its gradient, ``transpose``/``with_weight``, and
``fit(train.reorder='cluster')``.

Same numpy inputs into both packages. Integer arrays must be identical (both
packages build them from the same native calls and numpy arithmetic). The
port builds no blocked layout: ``spmm`` over a relabelled adjacency is K1's
plain version over its CSR on the CPU, bit for bit. Against the JAX
package's blocked product: rtol=1e-5, atol=1e-6, float32 sums in another
order. Loss curves: rtol=1e-4, as in tests/test_torch_train.py. The dense
oracles are scipy/numpy in float64.
"""

import dataclasses
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jg
from gnn_tpu import native as jnative
from gnn_tpu import nn as jnn
from gnn_tpu.graphs import blocked as jb
from gnn_tpu.graphs.datasets import load_dataset as jax_load_dataset
from gnn_tpu.models import GAT as JaxGAT
from gnn_tpu.models import GCN as JaxGCN
from gnn_tpu.ops import spmm as jax_spmm
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch import native as tnative
from gnn_tpu_torch import ops as tops
from gnn_tpu_torch.graphs import blocked as tb
from gnn_tpu_torch.models import GAT, GCN
from gnn_tpu_torch.nn import load_jax_state_dict
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm_plain
from gnn_tpu_torch.train import Config, fit
from torch_jax_graph_core import jax_graph_core  # noqa: F401  (fixture)

# the JAX package's draws and graph-core results come from its C++ library
pytestmark = pytest.mark.usefixtures("jax_graph_core")

TOL = dict(rtol=1e-5, atol=1e-6)


def _clustered_graph(n=600, k=12, seed=0):
    """An SBM with strong communities and its gcn_norm weights (the port's;
    the same arrays go to both packages)."""
    d = tg.stochastic_block_model(n, k, p_in=0.12, p_out=0.004, seed=seed)
    ei, w = tg.gcn_norm(d.edge_index.numpy(), num_nodes=n)
    return ei, w


def _dense(ei, w, n, perm):
    """The relabelled adjacency A[dst, src] as a float64 array."""
    a = np.zeros((n, n))
    np.add.at(a, (ei[1], ei[0]), w)
    return a[perm][:, perm]


def _both(ei, w, n, **kw):
    jkw = dict(kw)
    if kw.get("block_dtype") is not None:
        jkw["block_dtype"] = jnp.bfloat16
    jadj = jg.build_adjacency(ei, jnp.asarray(w), num_nodes=n, reorder="cluster", **jkw)
    tadj = tg.build_adjacency(ei, w, num_nodes=n, reorder="cluster", **kw)
    return jadj, tadj


def _csr(ei, n):
    order, rp = tnative.sort_edges_csr(ei[0], ei[1], n)
    return rp, ei[0].astype(np.int64)[order]


@pytest.mark.parametrize("n,seed", [(600, 3), (900, 5)])
def test_native_wrappers_match_jax(n, seed):
    ei, w = _clustered_graph(n, seed=seed)
    for a, b in zip(tnative.sort_edges_csr(ei[0], ei[1], n), jnative.sort_edges_csr(ei[0], ei[1], n)):
        np.testing.assert_array_equal(a, b)
    rp, col = _csr(ei, n)
    for kw in (dict(max_size=32, seed=0), dict(max_size=0, n_iters=4, seed=seed, weight=w)):
        t_lab, t_k = tnative.label_propagation(rp, col, **kw)
        j_lab, j_k = jnative.label_propagation(rp, col, **kw)
        np.testing.assert_array_equal(t_lab, j_lab)
        assert t_k == j_k
    np.testing.assert_array_equal(tnative.cluster_pack(t_lab, 32), jnative.cluster_pack(t_lab, 32))
    win = np.arange(n) // 32
    t_win, t_swaps = tnative.refine_windows(rp, col, win, -(-n // 32), n_sweeps=2)
    j_win, j_swaps = jnative.refine_windows(rp, col, win, -(-n // 32), n_sweeps=2)
    np.testing.assert_array_equal(t_win, j_win)
    assert t_swaps == j_swaps > 0
    np.testing.assert_array_equal(win, np.arange(n) // 32)  # the caller's array is not written


def test_native_loader_raises_without_gxx_or_a_symbol(monkeypatch, tmp_path):
    src = tmp_path / "graph_native.cpp"
    src.write_text(tnative._SRC.read_text() + "\n// another hash\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_SRC", src)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.load()
    stale = tmp_path / "libstale.so"
    (tmp_path / "stale.cpp").write_text('extern "C" long sort_edges_csr() { return 0; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", str(tmp_path / "stale.cpp"), "-o", str(stale)], check=True)
    monkeypatch.setattr(tnative, "_build", lambda: stale)
    with pytest.raises(RuntimeError, match="lacks the symbol 'degrees'"):
        tnative.load()
    assert tnative._lib is None


def test_native_wrappers_check_their_inputs():
    rp, col = np.array([0, 1, 3]), np.array([1, 0, 1])
    with pytest.raises(ValueError, match="col ids"):
        tnative.label_propagation(rp, np.array([1, 0, 2]))
    with pytest.raises(ValueError, match="CSR offsets"):
        tnative.label_propagation(np.array([0, 1, 4]), col)
    with pytest.raises(ValueError, match="one value per entry"):
        tnative.label_propagation(rp, col, weight=np.ones(2))
    with pytest.raises(ValueError, match="window id"):
        tnative.refine_windows(rp, col, np.array([0, 2]), 2)
    with pytest.raises(ValueError, match="non-negative"):
        tnative.cluster_pack(np.array([0, -1]), 4)
    with pytest.raises(ValueError, match="out of range"):
        tnative.sort_edges_csr(np.array([0, 5]), np.array([1, 0]), 2)
    assert tnative.label_propagation(rp, col)[0].shape == (2,)


@pytest.mark.parametrize("rows", [32, 64])
def test_cluster_pack_order_native_plain_and_jax(rows):
    """Port of tests/test_blocked.py:34, with the native packing, the Python
    scan and the JAX package's order all equal."""
    labels = np.random.default_rng(0).integers(0, 37, 500)
    perm = tb.cluster_pack_order(labels, rows)
    np.testing.assert_array_equal(tb.cluster_pack_order_plain(labels, rows), perm)
    np.testing.assert_array_equal(jb.cluster_pack_order(labels, rows), perm)
    assert sorted(perm.tolist()) == list(range(500))
    lab_new = labels[perm]
    for lab in np.unique(labels):
        pos = np.nonzero(lab_new == lab)[0]
        runs = 1 + int(np.sum(np.diff(pos) > 1))
        assert runs <= -(-len(pos) // rows) + 1, (lab, runs, len(pos))


def test_cluster_order_matches_jax_and_keeps_boundaries():
    """cluster_order(pack_rows=R) equals the JAX package's; with refinement
    off every R-aligned boundary splits at most one community
    (tests/test_blocked.py:48), and refinement only raises the capture."""
    ei, _ = _clustered_graph(600, seed=3)
    R = 32
    perm = tg.cluster_order(ei, 600, pack_rows=R, refine_sweeps=0)
    np.testing.assert_array_equal(perm, jg.cluster_order(ei, 600, pack_rows=R, refine_sweeps=0))
    refined = tg.cluster_order(ei, 600, pack_rows=R)
    np.testing.assert_array_equal(refined, jg.cluster_order(ei, 600, pack_rows=R))
    np.testing.assert_array_equal(tg.cluster_order(ei, 600, max_size=50), jg.cluster_order(ei, 600, max_size=50))
    with pytest.raises(ValueError, match="pack_rows"):
        tg.cluster_order(ei, 600, pack_rows=R, max_size=16)

    rp, col = _csr(ei, 600)
    labels, _ = tnative.label_propagation(rp, col, max_size=R, n_iters=10, seed=0)
    lab_new = labels[perm]
    for b in range(0, 600 - R, R):
        assert len(set(lab_new[b : b + R]) & set(lab_new[b + R :])) <= 1, b

    def capture(p):
        old2new = np.empty(600, np.int64)
        old2new[p] = np.arange(600)
        return float((old2new[ei[0]] // R == old2new[ei[1]] // R).mean())

    assert sorted(refined.tolist()) == list(range(600))
    assert capture(refined) >= capture(perm)


CSR = ("perm", "src", "dst", "row_ptr", "t_perm", "t_row_ptr")


def _assert_csr_equals_jax(tadj, jadj):
    for name in CSR:
        got = getattr(tadj, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jadj, name)), err_msg=name)


@pytest.mark.parametrize(
    "block_rows,block_dtype", [(32, None), (64, None), (64, torch.bfloat16)], ids=["R32", "R64", "R64-bf16"]
)
def test_build_adjacency_cluster_identical(block_rows, block_dtype):
    """The relabelling and the CSR equal the JAX package's; the JAX blocked
    layout's windows are real (dense and inter-window edges both present),
    and ``block_dtype``, the type of those windows there, changes nothing
    here."""
    ei, w = _clustered_graph(600, seed=1)
    jadj, tadj = _both(ei, w, 600, block_rows=block_rows, block_dtype=block_dtype)
    _assert_csr_equals_jax(tadj, jadj)
    np.testing.assert_array_equal(tadj.weight.numpy(), np.asarray(jadj.weight))
    np.testing.assert_array_equal(tadj.t_weight.numpy(), np.asarray(jadj.weight)[np.asarray(jadj.t_perm)])
    assert tadj.layout == "blocked" and jadj.blocked.num_dense_edges > 0 and jadj.blocked.num_rem_edges > 0
    plain = tg.build_adjacency(ei, w, num_nodes=600, reorder="cluster", block_rows=block_rows)
    for f in dataclasses.fields(tadj):
        a, b = getattr(tadj, f.name), getattr(plain, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    moved = tadj.to("cpu")
    assert torch.equal(moved.perm, tadj.perm) and moved.layout == "blocked"


@pytest.mark.parametrize(
    "block_rows,block_dtype", [(32, None), (64, None), (64, torch.bfloat16)], ids=["R32", "R64", "R64-bf16"]
)
def test_cluster_spmm_is_k1_over_its_csr(block_rows, block_dtype):
    """``spmm`` over a ``reorder='cluster'`` adjacency, every backend that
    takes it, is K1 over the relabelled CSR: forward and dx equal K1's
    plain version over the CSR and its transpose bit for bit."""
    n = 600
    ei, w = _clustered_graph(n, seed=1)
    tadj = tg.build_adjacency(ei, w, num_nodes=n, reorder="cluster", block_rows=block_rows, block_dtype=block_dtype)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    want = csr_spmm_plain(tadj.row_ptr, tadj.src, tadj.weight, x)
    want_dx = csr_spmm_plain(tadj.t_row_ptr, tadj.t_col, tadj.t_weight, g)
    for backend in ("auto", "segment", "blocked"):
        xt = x.clone().requires_grad_()
        out = tops.spmm(tadj, xt, backend=backend)
        out.backward(g)
        assert torch.equal(out.detach(), want), backend
        assert torch.equal(xt.grad, want_dx), backend


@pytest.mark.parametrize("rem_backend", ["auto", "bucket", "levels", "kernel"])
def test_blocked_matvec_matches_jax_and_dense(rem_backend):
    """Every rem_backend is accepted and builds the same CSR in the port;
    ``spmm`` over it is held to the JAX package's blocked product with the
    layout of that backend and to a dense oracle (tests/test_blocked.py:99)."""
    n = 600
    ei, w = _clustered_graph(n, seed=1)
    jadj, tadj = _both(ei, w, n, block_rows=64, rem_backend=rem_backend)
    _assert_csr_equals_jax(tadj, jadj)
    x = np.random.default_rng(2).normal(size=(n, 24)).astype(np.float32)
    want = np.asarray(jb.blocked_matvec(jadj.blocked, jnp.asarray(x)))
    got = tops.spmm(tadj, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    a = _dense(ei, w, n, tadj.perm.long().numpy())
    np.testing.assert_allclose(got.numpy(), a @ x, **TOL)


def test_blocked_grad_matches_jax_and_csr():
    """dx through ``spmm`` over a cluster adjacency: jax.grad of the JAX
    package's blocked spmm, and the port's 'segment' backend on the same
    relabelled adjacency, the same K1 bit for bit (tests/test_blocked.py:128)."""
    n = 320
    ei, w = _clustered_graph(n, k=8, seed=5)
    jadj, tadj = _both(ei, w, n, block_rows=32)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    ct = rng.normal(size=(n, 16)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_spmm(jadj, v) ** 2 * ct))(jnp.asarray(x))
    grads = []
    for backend in ("auto", "segment"):
        xt = torch.from_numpy(x).requires_grad_()
        (tops.spmm(tadj, xt, backend=backend) ** 2 * torch.from_numpy(ct)).sum().backward()
        grads.append(xt.grad.numpy())
    np.testing.assert_allclose(grads[0], np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(grads[0], grads[1])


def test_blocked_transpose_and_weight_swap():
    """tests/test_blocked.py:152 through the port, and the transposed
    CSR equal to the JAX package's."""
    n = 320
    ei, w = _clustered_graph(n, k=8, seed=6)
    jadj, tadj = _both(ei, w, n, block_rows=32)
    a = _dense(ei, w, n, tadj.perm.long().numpy())
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 8)).astype(np.float32))
    t = tadj.transpose()
    jt = jadj.transpose()
    _assert_csr_equals_jax(t, jt)
    assert t.layout == "blocked"
    np.testing.assert_allclose(tops.spmm(t, x).numpy(), a.T @ x.numpy(), **TOL)
    np.testing.assert_allclose(tops.spmm(t, x, backend="segment").numpy(), a.T @ x.numpy(), **TOL)
    # a weight swap after the transpose reaches both directions
    t3 = t.with_weight(t.weight * 3.0)
    np.testing.assert_allclose(tops.spmm(t3, x).numpy(), 3.0 * (a.T @ x.numpy()), rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(tops.spmm(t3, x, backend="segment").numpy(), 3.0 * (a.T @ x.numpy()),
                               rtol=1e-5, atol=5e-6)
    doubled = tadj.with_weight(tadj.weight * 2.0)
    np.testing.assert_allclose(tops.spmm(doubled, x).numpy(), 2.0 * tops.spmm(tadj, x).numpy(), rtol=1e-6)
    ones = tadj.with_weight(None)
    # as in the JAX package, an adjacency that had weights takes ones
    assert ones.weight is None and ones.t_weight is None
    np.testing.assert_allclose(tops.spmm(ones, x).numpy(), (a != 0) @ x.numpy(), **TOL)
    np.testing.assert_allclose(
        tops.spmm(ones, x).numpy(), np.asarray(jax_spmm(jadj.with_weight(None), jnp.asarray(x.numpy()))), **TOL
    )


def test_blocked_directed_graph():
    """A directed graph (tests/test_blocked.py:303): the same relabelling as
    the JAX package, and outputs and gradients equal to the dense oracle."""
    rng = np.random.default_rng(21)
    n = 300
    ei, _ = tg.coalesce(np.stack([rng.integers(0, n, 2500), rng.integers(0, n, 2500)]), num_nodes=n)
    w = rng.random(ei.shape[1]).astype(np.float32)
    jadj, tadj = _both(ei, w, n, block_rows=32)
    _assert_csr_equals_jax(tadj, jadj)
    a = _dense(ei, w, n, tadj.perm.long().numpy())
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).requires_grad_()
    out = tops.spmm(tadj, x)
    np.testing.assert_allclose(out.detach().numpy(), a @ x.detach().numpy(), **TOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * a.T @ (a @ x.detach().numpy()), rtol=1e-5, atol=1e-5)


def test_blocked_cpu_path_and_checks():
    """The backend and the options are checked; data.permute_nodes equals
    the JAX package's."""
    ei, w = _clustered_graph(300, k=6, seed=2)
    x = torch.randn(300, 8)
    with pytest.raises(ValueError, match="reorder='cluster'"):
        tops.spmm(tg.build_adjacency(ei, w, num_nodes=300), x, backend="blocked")
    with pytest.raises(ValueError, match="rem_backend"):
        tg.build_adjacency(ei, w, num_nodes=300, reorder="cluster", rem_backend="slots")
    with pytest.raises(ValueError, match="square"):
        tg.build_adjacency(ei, w, num_src_nodes=300, num_dst_nodes=301, reorder="cluster")
    with pytest.raises(ValueError, match="cluster_labels"):
        tg.build_adjacency(ei, w, num_nodes=300, reorder="cluster", cluster_labels=np.zeros(5))

    from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm

    td, jd = tg.stochastic_block_model(200, 4, seed=4), jax_sbm(200, 4, seed=4)
    perm = np.random.default_rng(1).permutation(200)
    tp, jp = td.permute_nodes(torch.from_numpy(perm)), jd.permute_nodes(perm)
    for name in ("x", "edge_index", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)


def _fit_cfg(model: str, **over):
    model_cfg = {"name": "gcn", "hidden": 16, "dropout": 0.0}
    if model == "gat":
        model_cfg = {"name": "gat", "hidden": 8, "heads": 4, "dropout": 0.0}
    cfg = Config.from_dict(
        {
            "dataset": "sbm",
            "model": model_cfg,
            "optim": {"lr": 0.01},
            "train": {"epochs": 5, "eval_every": 1, "reorder": "cluster"},
        }
    )
    return cfg.apply_overrides([f"{k}={v}" for k, v in over.items()])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_fit_cluster_losses_match_jax(model):
    """fit(train.reorder='cluster'): the 5-epoch loss curve of
    gnn_tpu.train.fit with the same config and initial weights, dropout 0.
    GCN and GAT both read the relabelled CSR (the JAX GCN runs its blocked
    product)."""
    jdata, tdata = jax_load_dataset("sbm"), tg.load_dataset("sbm")
    f = tdata.num_features
    if model == "gcn":
        jmodel = JaxGCN(f, 16, 4, key=jax.random.PRNGKey(2), dropout=0.0)
        tmodel = GCN(f, 16, 4, dropout=0.0)
    else:
        jmodel = JaxGAT(f, 8, 4, key=jax.random.PRNGKey(2), heads=4, dropout=0.0)
        tmodel = GAT(f, 8, 4, heads=4, dropout=0.0)
    tmodel = load_jax_state_dict(tmodel, {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()})
    _, _, jhist = jax_fit(JaxConfig.from_json(_fit_cfg(model).to_json()), jdata, model=jmodel, verbose=False)
    _, _, thist = fit(_fit_cfg(model), tdata, model=tmodel, device="cpu", verbose=False)
    assert len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    for split in ("train_acc", "val_acc", "test_acc"):
        assert abs(thist[-1][split] - jhist[-1][split]) <= 0.01, split
