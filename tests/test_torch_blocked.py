"""The port's cluster-blocked path against gnn_tpu: the native graph core,
the packing and refinement orders, ``build_adjacency(reorder='cluster')``,
``blocked_matvec`` and its remainder, the blocked ``spmm`` and its gradient,
``transpose``/``with_weight``, and ``fit(train.reorder='cluster')``.

Same numpy inputs into both packages. Integer arrays and the block values
must be identical (both packages build them from the same native calls and
numpy arithmetic). Products: rtol=1e-5, atol=1e-6, float32 sums in another
order. Loss curves: rtol=1e-4, as in tests/test_torch_train.py. The dense
oracles are scipy/numpy in float64.
"""

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
from gnn_tpu.ops.pallas.segment import build_chunk_plan, segment_sum_sorted
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


def _assert_layouts_equal(tl, jl):
    np.testing.assert_array_equal(tl.diag.float().numpy(), np.asarray(jl.diag.astype(jnp.float32)))
    assert tl.diag.dtype == (torch.bfloat16 if jl.diag.dtype == jnp.bfloat16 else torch.float32)
    for name in ("diag_pos", "diag_eid", "rem_src", "rem_dst", "rem_w", "rem_eid"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)), err_msg=name)
    rem_dst = np.asarray(jl.rem_dst)
    np.testing.assert_array_equal(
        tl.rem_row_ptr.numpy(), np.concatenate([[0], np.cumsum(np.bincount(rem_dst, minlength=tl.num_nodes))])
    )
    assert (tl.num_nodes, tl.rows, tl.num_blocks) == (jl.num_nodes, jl.rows, jl.num_blocks)


@pytest.mark.parametrize(
    "block_rows,block_dtype", [(32, None), (64, None), (64, torch.bfloat16)], ids=["R32", "R64", "R64-bf16"]
)
def test_build_adjacency_cluster_identical(block_rows, block_dtype):
    ei, w = _clustered_graph(600, seed=1)
    jadj, tadj = _both(ei, w, 600, block_rows=block_rows, block_dtype=block_dtype)
    for name in ("perm", "src", "dst", "row_ptr", "t_perm", "t_row_ptr"):
        got = getattr(tadj, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jadj, name)), err_msg=name)
    np.testing.assert_array_equal(tadj.weight.numpy(), np.asarray(jadj.weight))
    _assert_layouts_equal(tadj.blocked, jadj.blocked)
    _assert_layouts_equal(tadj.t_blocked, jadj.t_blocked)
    assert tadj.blocked.num_dense_edges > 0 and tadj.blocked.num_rem_edges > 0
    moved = tadj.to("cpu")
    assert moved.blocked.num_rem_edges == tadj.blocked.num_rem_edges and moved.perm is not None


@pytest.mark.parametrize("rem_backend", ["auto", "bucket", "levels", "kernel"])
def test_blocked_matvec_matches_jax_and_dense(rem_backend):
    """Every rem_backend builds the same CSR remainder in the port; each is
    held to the JAX package's layout of that backend and to a dense oracle
    (tests/test_blocked.py:99)."""
    n = 600
    ei, w = _clustered_graph(n, seed=1)
    jadj, tadj = _both(ei, w, n, block_rows=64, rem_backend=rem_backend)
    x = np.random.default_rng(2).normal(size=(n, 24)).astype(np.float32)
    want = np.asarray(jb.blocked_matvec(jadj.blocked, jnp.asarray(x)))
    got = tb.blocked_matvec(tadj.blocked, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    a = _dense(ei, w, n, tadj.perm.long().numpy())
    np.testing.assert_allclose(got.numpy(), a @ x, **TOL)
    np.testing.assert_allclose(tops.spmm(tadj, torch.from_numpy(x)).numpy(), a @ x, **TOL)


@pytest.mark.parametrize("direction", ["blocked", "t_blocked"])
def test_remainder_matches_pallas_kernel(direction):
    """The remainder's plain K1 against the JAX package's Pallas sorted
    segment sum in interpret mode, on the JAX layout's own remainder arrays
    (more than one 256-edge chunk, so the kernel path runs)."""
    n = 600
    ei, w = _clustered_graph(n, seed=1)
    jadj, tadj = _both(ei, w, n, block_rows=64, rem_backend="kernel")
    jl, tl = getattr(jadj, direction), getattr(tadj, direction)
    assert jl.num_rem_edges >= 256
    x = np.random.default_rng(4).normal(size=(n, 16)).astype(np.float32)
    msg = jnp.take(jnp.asarray(x), jl.rem_src, axis=0) * jl.rem_w[:, None]
    plan = build_chunk_plan(np.asarray(jl.rem_dst), n, chunk=256, rows=256)
    want = segment_sum_sorted(msg, plan, n, dst_sorted=jl.rem_dst, interpret=True)
    got = csr_spmm_plain(tl.rem_row_ptr, tl.rem_src, tl.rem_w, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_blocked_grad_matches_jax_and_csr():
    """dx through the blocked spmm: jax.grad of the JAX package's blocked
    spmm, and the port's CSR backend on the same relabelled adjacency
    (tests/test_blocked.py:128)."""
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
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-5)


def test_blocked_transpose_and_weight_swap():
    """tests/test_blocked.py:152 through the port, and the transposed
    layouts' edge ids equal to the JAX package's."""
    n = 320
    ei, w = _clustered_graph(n, k=8, seed=6)
    jadj, tadj = _both(ei, w, n, block_rows=32)
    a = _dense(ei, w, n, tadj.perm.long().numpy())
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 8)).astype(np.float32))
    t = tadj.transpose()
    jt = jadj.transpose()
    for name in ("src", "dst", "row_ptr", "t_perm", "t_row_ptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jt, name)), err_msg=name)
    for tl, jl in ((t.blocked, jt.blocked), (t.t_blocked, jt.t_blocked)):
        np.testing.assert_array_equal(tl.diag_eid.numpy(), np.asarray(jl.diag_eid))
        np.testing.assert_array_equal(tl.rem_eid.numpy(), np.asarray(jl.rem_eid))
    np.testing.assert_allclose(tops.spmm(t, x).numpy(), a.T @ x.numpy(), **TOL)
    np.testing.assert_allclose(tops.spmm(t, x, backend="segment").numpy(), a.T @ x.numpy(), **TOL)
    # a weight swap after the transpose goes through the remapped edge ids
    t3 = t.with_weight(t.weight * 3.0)
    np.testing.assert_allclose(tops.spmm(t3, x).numpy(), 3.0 * (a.T @ x.numpy()), rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(tops.spmm(t3, x, backend="segment").numpy(), 3.0 * (a.T @ x.numpy()),
                               rtol=1e-5, atol=5e-6)
    doubled = tadj.with_weight(tadj.weight * 2.0)
    np.testing.assert_allclose(tops.spmm(doubled, x).numpy(), 2.0 * tops.spmm(tadj, x).numpy(), rtol=1e-6)
    ones = tadj.with_weight(None)
    # as in the JAX package, a layout that had weights re-bakes ones
    assert ones.t_weight is None and bool((ones.blocked.rem_w == 1).all())
    np.testing.assert_allclose(tops.spmm(ones, x).numpy(), (a != 0) @ x.numpy(), **TOL)


def test_blocked_directed_graph():
    """A directed graph (tests/test_blocked.py:303): the same relabelling as
    the JAX package, and outputs and gradients equal to the dense oracle."""
    rng = np.random.default_rng(21)
    n = 300
    ei, _ = tg.coalesce(np.stack([rng.integers(0, n, 2500), rng.integers(0, n, 2500)]), num_nodes=n)
    w = rng.random(ei.shape[1]).astype(np.float32)
    jadj, tadj = _both(ei, w, n, block_rows=32)
    np.testing.assert_array_equal(tadj.perm.numpy(), np.asarray(jadj.perm))
    _assert_layouts_equal(tadj.t_blocked, jadj.t_blocked)
    a = _dense(ei, w, n, tadj.perm.long().numpy())
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).requires_grad_()
    out = tops.spmm(tadj, x)
    np.testing.assert_allclose(out.detach().numpy(), a @ x.detach().numpy(), **TOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * a.T @ (a @ x.detach().numpy()), rtol=1e-5, atol=1e-5)


def test_blocked_cpu_path_and_checks():
    """CPU tensors take the plain version and count no launch; the layout
    is checked; data.permute_nodes equals the JAX package's."""
    ei, w = _clustered_graph(300, k=6, seed=2)
    tadj = tg.build_adjacency(ei, w, num_nodes=300, reorder="cluster", block_rows=32)
    x = torch.randn(300, 8)
    before = tb.blocked_matvec.launches
    torch.testing.assert_close(
        tb.blocked_matvec(tadj.blocked, x), tb.blocked_matvec_plain(tadj.blocked, x), rtol=0, atol=0
    )
    assert tb.blocked_matvec.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tb.blocked_matvec(tadj.blocked, x.to("meta"))
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
    GAT reads the relabelled CSR; GCN runs the blocked spmm."""
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
    before = tb.blocked_matvec.launches
    _, _, thist = fit(_fit_cfg(model), tdata, model=tmodel, device="cpu", verbose=False)
    assert tb.blocked_matvec.launches == before  # CPU: the plain version, no count
    assert len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    for split in ("train_acc", "val_acc", "test_acc"):
        assert abs(thist[-1][split] - jhist[-1][split]) <= 0.01, split


def test_cora_like_kipf_accuracy_band_cluster_layout():
    """Port of tests/test_models.py:219: the Kipf recipe through the
    cluster-blocked layout lands in the Cora band."""
    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.dropout = "gcn", 16, 0.5
    cfg.optim.lr, cfg.optim.weight_decay = 0.01, 5e-4
    cfg.train.epochs, cfg.train.eval_every = 200, 200
    cfg.train.reorder = "cluster"
    _, _, hist = fit(cfg, tg.cora_like(seed=0), device="cpu", verbose=False)
    acc = hist[-1]["test_acc"]
    assert 0.78 <= acc <= 0.88, f"outside Cora band: {acc}"
