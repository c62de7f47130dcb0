"""The degree-bucket relabelling (``reorder=True`` / ``'auto'``) and the JAX
package's layout choices, against gnn_tpu on the same numpy inputs.

``perm``, the relabelled CSR arrays and every error: exact. ``spmm`` over
the ``'sorted'`` and ``'ell'`` backends (the JAX slot tables against K1's
plain version over the CSR), forward and dx: rtol=1e-5, atol=1e-6 (float32
sums in another order). The 5-epoch ``fit`` loss curves under ``'auto'`` and
``'true'`` (dropout 0, weights carried over): rtol=1e-4, as in
tests/test_torch_train.py; the trained models' logits on the relabelled
data: rtol=1e-3, atol=1e-4 (five Adam steps compound the order differences).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jg
from gnn_tpu import nn as jnn
from gnn_tpu import ops as jops
from gnn_tpu.graphs import generate as jgen
from gnn_tpu.graphs.datasets import load_dataset as jax_load_dataset
from gnn_tpu.models import GAT as JaxGAT
from gnn_tpu.models import GCN as JaxGCN
from gnn_tpu.models import EncoderGCN as JaxEncoderGCN
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch import ops as tops
from gnn_tpu_torch.graphs.sorted_ell import degree_bucket_order
from gnn_tpu_torch.models import GAT, GCN, EncoderGCN
from gnn_tpu_torch.nn import load_jax_state_dict
from gnn_tpu_torch.train import Config, fit
from gnn_tpu_torch.train.loop import build_step

SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
CSR_FIELDS = ("src", "dst", "row_ptr", "t_perm", "t_row_ptr", "weight")


def _power_law(n=2000):
    ei, _ = tg.to_undirected(tg.power_law(n, 6 * n, seed=0), num_nodes=n)
    x = np.zeros((n, 4), np.float32)
    return jg.Data(x=x, edge_index=ei, num_nodes=n), tg.Data(x=x, edge_index=ei, num_nodes=n)


GRAPHS = {
    "power_law": _power_law,
    "sbm": lambda: (jgen.stochastic_block_model(400, 4, seed=3), tg.stochastic_block_model(400, 4, seed=3)),
    "karate": lambda: (jgen.karate_club(), tg.karate_club()),
    "cora_like": lambda: (jgen.cora_like(seed=0), tg.cora_like(seed=0)),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


@pytest.mark.parametrize("reorder", ["auto", True])
def test_perm_and_csr_equal_jax(graph, reorder):
    """After gcn_norm's self loops: the same relabelling element for
    element, the same relabelled CSR, the same layout choice and
    edge_agg where the JAX package builds it."""
    jd, td = graph
    ja = jd.to_adjacency(norm="sym", reorder=reorder)
    ta = td.to_adjacency(norm="sym", reorder=reorder)
    assert ja.perm is not None and ta.perm.dtype == torch.int32
    np.testing.assert_array_equal(ta.perm.numpy(), np.asarray(ja.perm))
    for name in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)), err_msg=name)
    assert ta.layout == ("sorted" if ja.sorted_ell is not None else "csr")
    assert (ta.edge_agg is not None) == (ja.edge_agg is not None)
    t = ta.transpose()
    assert t.perm is ta.perm and t.layout == ta.layout and (t.edge_agg is None) == (ta.edge_agg is None)


@pytest.mark.parametrize("hub_dense", [4, 8, 10_000])
def test_hub_dense_order_equals_jax(hub_dense):
    """With ``hub_dense`` the order comes from the in-degree over the
    non-hub sources (none at 10,000); the dense hub block itself is TPU
    machinery and builds nothing."""
    jd, td = _power_law()
    ja = jd.to_adjacency(norm="sym", reorder=True, hub_dense=hub_dense, hub_dtype=jnp.bfloat16)
    ta = td.to_adjacency(norm="sym", reorder=True, hub_dense=hub_dense, hub_dtype=torch.bfloat16)
    np.testing.assert_array_equal(ta.perm.numpy(), np.asarray(ja.perm))
    np.testing.assert_array_equal(ta.src.numpy(), np.asarray(ja.src))


def test_degree_bucket_order_equals_jax(rng):
    """Isolated nodes and multiples of the effective kmax lead; stable
    within a bucket; degrees past KMAX wrap."""
    from gnn_tpu.graphs.sorted_ell import degree_bucket_order as jax_order

    deg = np.concatenate([rng.integers(0, 40, 500), [0, 0, 24, 48, 512, 1024, 700, 3]])
    for d in (deg, deg[:50] % 7, np.zeros(5, np.int64), np.array([], np.int64)):
        np.testing.assert_array_equal(degree_bucket_order(d), jax_order(d))


def test_asymmetric_graph_true_raises_auto_keeps_ids(rng):
    n = 300
    ei = np.stack([rng.integers(0, n, 2500), rng.integers(0, n, 2500)])
    with pytest.raises(ValueError) as want:
        jg.build_adjacency(ei, num_nodes=n, reorder=True)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tg.build_adjacency(ei, num_nodes=n, reorder=True)
    ja, ta = jg.build_adjacency(ei, num_nodes=n, reorder="auto"), tg.build_adjacency(ei, num_nodes=n, reorder="auto")
    assert ja.perm is None and ta.perm is None
    assert ta.layout == "ell" and ja.ell is not None and ta.edge_agg is not None


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(hub_dense=4),
        dict(reorder="cluster", hub_dense=4),
        dict(layout="blocked"),
        dict(layout="ell", ell_buckets=()),
    ],
    ids=["hub-without-reorder", "hub-with-cluster", "unknown-layout", "empty-buckets"],
)
def test_option_errors_equal_jax(kwargs):
    jd, td = _power_law()
    with pytest.raises(ValueError) as want:
        jd.to_adjacency(norm="sym", **kwargs)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        td.to_adjacency(norm="sym", **kwargs)


@pytest.mark.parametrize(
    "layout,reorder,n_edges,want",
    [
        ("auto", False, 3000, "ell"),
        ("auto", False, 1000, "csr"),
        ("auto", True, 3000, "sorted"),
        ("auto", True, 1000, "csr"),
        ("ell", True, 1000, "sorted"),
        ("ell", False, 1000, "ell"),
        ("csr", True, 3000, "csr"),
    ],
)
def test_layout_choice_equals_jax(rng, layout, reorder, n_edges, want):
    n = 400
    ei, _ = tg.to_undirected(np.stack([rng.integers(0, n, n_edges // 2), rng.integers(0, n, n_edges // 2)]),
                             num_nodes=n)
    ja = jg.build_adjacency(ei, num_nodes=n, layout=layout, reorder=reorder)
    ta = tg.build_adjacency(ei, num_nodes=n, layout=layout, reorder=reorder)
    jax_layout = "sorted" if ja.sorted_ell is not None else "ell" if ja.ell is not None else "csr"
    assert ta.layout == jax_layout == want
    assert (ta.edge_agg is not None) == (ja.edge_agg is not None) == (want != "csr")


@pytest.mark.parametrize("backend,reorder", [("sorted", True), ("ell", False), ("segment", True)])
def test_spmm_backends_match_jax(backend, reorder, rng):
    """Forward and dx over each backend: the JAX slot tables against K1's
    plain version over the (relabelled) CSR; 'auto' takes the same path."""
    jd, td = _power_law(600)
    ja = jd.to_adjacency(norm="sym", reorder=reorder)
    ta = td.to_adjacency(norm="sym", reorder=reorder)
    x = rng.normal(size=(600, 16)).astype(np.float32)
    ct = rng.normal(size=(600, 16)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda v: jops.spmm(ja, v, backend=backend), jnp.asarray(x))
    (j_dx,) = vjp(jnp.asarray(ct))
    for b in (backend, "auto"):
        xt = torch.from_numpy(x).requires_grad_()
        out = tops.spmm(ta, xt, backend=b)
        out.backward(torch.from_numpy(ct))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **SPMM_TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **SPMM_TOL)


@pytest.mark.parametrize(
    "backend,reorder,layout",
    [("sorted", False, "auto"), ("sorted", "auto", "csr"), ("ell", True, "auto"), ("ell", False, "csr"),
     ("pallas", False, "auto"), ("bogus", False, "auto")],
)
def test_spmm_backend_errors_equal_jax(backend, reorder, layout):
    jd, td = _power_law(600)
    x = np.zeros((600, 4), np.float32)
    with pytest.raises(ValueError) as want:
        jops.spmm(jd.to_adjacency(norm="sym", reorder=reorder, layout=layout), jnp.asarray(x), backend=backend)
    first = str(want.value).split(":")[0]
    with pytest.raises(ValueError, match=re.escape(first)):
        tops.spmm(td.to_adjacency(norm="sym", reorder=reorder, layout=layout), torch.from_numpy(x), backend=backend)


def _cfg(name, reorder):
    cfg = Config.from_dict(
        {
            "dataset": "sbm",
            "model": {"name": name, "hidden": 8 if name == "gat" else 16, "heads": 4, "dropout": 0.0},
            "optim": {"lr": 0.005 if name == "gat" else 0.01},
            "train": {"epochs": 5, "eval_every": 1, "reorder": reorder},
        }
    )
    return cfg


def _models(name, n_features):
    key = jax.random.PRNGKey(2)
    if name == "gcn":
        jm, tm = JaxGCN(n_features, 16, 4, key=key, dropout=0.0), GCN(n_features, 16, 4, dropout=0.0)
    elif name == "gat":
        jm, tm = JaxGAT(n_features, 8, 4, key=key, heads=4, dropout=0.0), GAT(n_features, 8, 4, heads=4, dropout=0.0)
    else:
        jm, tm = JaxEncoderGCN(n_features, 4, key=key, num_layers=2), EncoderGCN(n_features, 4, num_layers=2)
    return jm, load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jnn.state_dict(jm).items()})


@pytest.mark.parametrize("reorder", ["auto", "true"])
@pytest.mark.parametrize("name", ["gcn", "gat", "encoder_gcn"])
def test_fit_relabels_and_matches_jax(name, reorder):
    """``fit`` relabels as the JAX ``fit`` does (the step's adjacency has
    its ``perm``), its 5-epoch loss curve equals the JAX one, and (GCN,
    GAT) the trained models give the same logits on the relabelled data.
    EncoderGCN's logits are left out: under Adam one of its biases and the
    running mean that follows it are rounding noise (tests/test_torch_encoder.py)."""
    jdata, tdata = jax_load_dataset("sbm"), tg.load_dataset("sbm")
    cfg = _cfg(name, reorder)
    jm, tm = _models(name, tdata.num_features)
    jadj = jdata.to_adjacency(norm="sym", reorder=True if reorder == "true" else "auto")
    step = build_step(cfg, tdata, tm, torch.device("cpu"))
    np.testing.assert_array_equal(step.adj.perm.numpy(), np.asarray(jadj.perm))
    jmodel, _, jhist = jax_fit(JaxConfig.from_json(cfg.to_json()), jdata, model=jm, verbose=False)
    tmodel, _, thist = fit(cfg, tdata, model=tm, device="cpu", verbose=False)
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    if name != "encoder_gcn":
        jx = jdata.permute_nodes(np.asarray(jadj.perm)).x
        tmodel.eval()
        with torch.no_grad():
            got = tmodel(step.data.x, step.adj).numpy()
        np.testing.assert_allclose(got, np.asarray(jnn.inference_mode(jmodel)(jx, jadj)), rtol=1e-3, atol=1e-4)
