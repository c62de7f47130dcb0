"""The port's models on a node-partitioned graph, and ``fit``'s distributed
and data-parallel sampled branches, against the JAX package's single-device
models and ``fit`` (parts on the CPU; no ``shard_map``).

Layers and models: the same weights (carried by ``load_jax_state_dict``)
on the JAX single-device adjacency and on the port's ``DistGraph``; outputs
and parameter gradients at rtol=1e-4, atol=1e-5 (float32 sums in another
order). ``fit``: the 6-epoch loss curve at rtol=1e-4 and every logged
accuracy at atol=1e-6, as ``tests/test_parallel.py`` holds the JAX
distributed ``fit`` to the single-device one.
"""

import jax
import numpy as np
import pytest
import torch

from gnn_tpu import graphs as jgraphs
from gnn_tpu import nn as jnn
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.mp import GATConv as JaxGATConv
from gnn_tpu.mp import SAGEConv as JaxSAGEConv
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu.train.loop import build_model as jax_build_model
from gnn_tpu_torch.graphs import cluster_order, stochastic_block_model
from gnn_tpu_torch.graphs.sampling import NeighborSampler
from gnn_tpu_torch.models import EncoderGCN, GraphSAGE
from gnn_tpu_torch.mp import GATConv, SAGEConv
from gnn_tpu_torch.nn import cross_entropy, load_jax_state_dict
from gnn_tpu_torch.parallel import make_mesh, partition_graph, shard_node_array
from gnn_tpu_torch.train import Config, fit
from gnn_tpu_torch.train.loop import build_model, build_step

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def _mesh(P):
    return make_mesh(axes=("data",), devices=[CPU] * P)


def _graph(rng, n=96, e=500):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ei, _ = jgraphs.coalesce(np.stack([src, dst]), num_nodes=n)
    ei, _ = jgraphs.add_self_loops(np.asarray(ei), num_nodes=n)
    return np.asarray(ei), rng.normal(size=(n, 16)).astype(np.float32), n


def _params(jmodel):
    return {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()}


def _check_layer(jconv, tconv, jadj, dist, x, mesh):
    """Output and parameter gradients of sum(sin(conv(x)))."""
    x_sh = shard_node_array(dist, x, mesh)
    out = tconv(x_sh, dist)
    np.testing.assert_allclose(dist.unshard_nodes(out).detach().numpy(), np.asarray(jconv(x, jadj)), **TOL)
    torch.sin(dist.unshard_nodes(out)).sum().backward()
    params, static = jnn.partition(jconv)
    grads = jnn.state_dict(jax.grad(lambda p: jax.numpy.sum(jax.numpy.sin(jnn.combine(p, static)(x, jadj))))(params))
    for name, p in tconv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[name]), err_msg=name, **TOL)


@pytest.mark.parametrize("halo", ["allgather", "alltoall", "overlap"])
def test_gatconv_on_a_dist_graph_matches_jax(rng, halo):
    ei, x, n = _graph(rng)
    jconv = JaxGATConv(16, 6, key=KEY, heads=2)
    tconv = load_jax_state_dict(GATConv(16, 6, heads=2), _params(jconv))
    mesh = _mesh(4)
    dist = partition_graph(ei, None, num_nodes=n, mesh=mesh, halo=halo)
    _check_layer(jconv, tconv, jgraphs.build_adjacency(ei, num_nodes=n, layout="csr"), dist, x, mesh)
    with pytest.raises(ValueError, match="single-device"):
        tconv(shard_node_array(dist, x, mesh), dist, return_attention=True)


@pytest.mark.parametrize("aggr", ["mean", "sum", "max"])
def test_sageconv_on_a_dist_graph_matches_jax(rng, aggr):
    ei, x, n = _graph(rng)
    jconv = JaxSAGEConv(16, 8, key=KEY, aggr=aggr)
    tconv = load_jax_state_dict(SAGEConv(16, 8, aggr=aggr), _params(jconv))
    mesh = _mesh(2)
    dist = partition_graph(ei, None, num_nodes=n, mesh=mesh, halo="alltoall")
    _check_layer(jconv, tconv, jgraphs.build_adjacency(ei, num_nodes=n, layout="csr"), dist, x, mesh)


def test_sage_on_a_weighted_partition_folds_the_weights_and_refuses_max(rng):
    """Mean on a weight-baked partition: the weighted message sum over the
    edge count, as on one device; weighted max raises the JAX error."""
    ei, x, n = _graph(rng)
    ei, w = jgraphs.gcn_norm(ei, num_nodes=n)
    ei, w = np.asarray(ei), np.asarray(w)
    jconv = JaxSAGEConv(16, 8, key=KEY, aggr="mean")
    tconv = load_jax_state_dict(SAGEConv(16, 8, aggr="mean"), _params(jconv))
    mesh = _mesh(4)
    dist = partition_graph(ei, w, num_nodes=n, mesh=mesh)
    jadj = jgraphs.build_adjacency(ei, jax.numpy.asarray(w), num_nodes=n, layout="csr")
    _check_layer(jconv, tconv, jadj, dist, x, mesh)
    with pytest.raises(ValueError, match="max"):
        SAGEConv(16, 8, aggr="max")(shard_node_array(dist, x, mesh), dist)


@pytest.mark.parametrize("name", ["gat", "sage", "gin", "gcn", "encoder_gcn"])
def test_models_run_unchanged_on_a_dist_graph(name):
    """models.GAT / GraphSAGE / GIN / GCN on a DistGraph: logits and
    parameter gradients equal the JAX single-device model's (GIN's plain sum
    through ``with_weight(None)``; GCN and EncoderGCN on the gcn_norm
    partition, EncoderGCN in inference mode)."""
    jd = jax_sbm(num_nodes=96, num_classes=3, seed=23)
    cfg = Config.from_dict({"model": {"name": name, "hidden": 8, "heads": 2, "dropout": 0.0}})
    F = int(jd.x.shape[1])
    jmodel = jax_build_model(JaxConfig.from_json(cfg.to_json()), F, 3, KEY)
    tmodel = load_jax_state_dict(build_model(cfg, F, 3), _params(jmodel))
    mesh = _mesh(4)
    x = np.asarray(jd.x)
    if name in ("gcn", "encoder_gcn"):
        jadj = jd.to_adjacency(norm="sym", layout="csr")
        dist = stochastic_block_model(num_nodes=96, num_classes=3, seed=23).to_dist_graph(mesh=mesh)
    else:
        ei, _ = jgraphs.add_self_loops(np.asarray(jd.edge_index), num_nodes=96)
        jadj = jgraphs.build_adjacency(ei, num_nodes=96, layout="csr")
        dist = partition_graph(np.asarray(ei), None, num_nodes=96, mesh=mesh, halo="alltoall")
    x_sh = shard_node_array(dist, x, mesh)
    if name == "encoder_gcn":
        tmodel.eval()
        want = np.asarray(jnn.inference_mode(jmodel)(x, jadj, jnn.init_state(jmodel))[0])
        np.testing.assert_allclose(dist.unshard_nodes(tmodel(x_sh, dist)).detach().numpy(), want, **TOL)
        return
    out = tmodel(x_sh, dist)
    np.testing.assert_allclose(dist.unshard_nodes(out).detach().numpy(), np.asarray(jmodel(x, jadj)), **TOL)
    torch.sin(dist.unshard_nodes(out)).sum().backward()
    params, static = jnn.partition(jmodel)
    grads = jnn.state_dict(jax.grad(lambda p: jax.numpy.sum(jax.numpy.sin(jnn.combine(p, static)(x, jadj))))(params))
    for pname, p in tmodel.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[pname]), err_msg=pname, **TOL)


def _fit_cfg(name, **dist):
    cfg = Config.from_dict({
        "model": {"name": name, "hidden": 8, "heads": 2, "dropout": 0.0},
        "optim": {"lr": 0.01},
        "train": {"epochs": 6, "eval_every": 2},
        "dist": dist,
    })
    return cfg


@pytest.mark.parametrize(
    "name,dist",
    [
        ("gcn", {"num_parts": 8}),
        ("sage", {"num_parts": 8}),
        ("gat", {"num_parts": 8}),
        ("gin", {"num_parts": 8}),
        ("encoder_gcn", {"num_parts": 8}),
        ("gcn", {"num_parts": 8, "local_blocked": 8}),
        ("gcn", {"num_parts": 4, "halo": "allgather"}),
        ("gat", {"num_parts": 2, "halo": "overlap", "cluster_order": True}),
    ],
    ids=["gcn", "sage", "gat", "gin", "encoder_gcn", "gcn-local_blocked", "gcn-allgather", "gat-overlap-cluster"],
)
def test_distributed_fit_matches_the_jax_single_device_fit(name, dist):
    """The port's ``fit`` on ``dist.num_parts`` parts against
    ``gnn_tpu.train.fit`` on one device, with the same initial weights (the
    JAX ``fit``'s own, carried over); EncoderGCN's BatchNorm statistics leave
    the padding rows out through the validity mask."""
    cfg = _fit_cfg(name, **dist)
    jdata = jax_sbm(num_nodes=120, num_classes=3, seed=31)
    tdata = stochastic_block_model(num_nodes=120, num_classes=3, seed=31)
    jcfg = JaxConfig.from_json(_fit_cfg(name).to_json())
    F = tdata.num_features
    jmodel = jax_build_model(jcfg, F, 3, jax.random.split(jax.random.PRNGKey(0))[1])
    tmodel = load_jax_state_dict(build_model(cfg, F, 3), _params(jmodel))
    _, _, jhist = jax_fit(jcfg, jdata, model=jmodel, verbose=False)
    _, state, thist = fit(cfg, tdata, model=tmodel, device="cpu", verbose=False)
    assert (state is not None) == (name == "encoder_gcn")
    assert len(thist) == len(jhist) == 3
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    for t, j in zip(thist, jhist):
        for split in ("train_acc", "val_acc", "test_acc"):
            np.testing.assert_allclose(t[split], j[split], atol=1e-6, err_msg=split)


def test_local_blocked_with_another_halo_warns_and_takes_overlap():
    cfg = _fit_cfg("gcn", num_parts=4, local_blocked=8, halo="allgather")
    cfg.train.epochs = 1
    data = stochastic_block_model(num_nodes=64, num_classes=3, seed=5)
    with pytest.warns(UserWarning, match="requires halo='overlap'"):
        step = build_step(cfg, data, build_model(cfg, data.num_features, 3), CPU)
    assert step.adj.halo == "overlap" and step.adj.n_max % 8 == 0
    # the community order in windows of 8 came first
    perm = cluster_order(data.edge_index.numpy(), data.num_nodes, pack_rows=8)
    assert torch.equal(step.data.x[: data.num_nodes], data.x[torch.from_numpy(perm)])
    assert step.data.num_nodes == 4 * step.adj.n_max and not step.data.train_mask[data.num_nodes:].any()


def test_distributed_fit_rejects_stateful_models_without_mask():
    class NoMaskEncoder(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, adj, *, generator=None):
            return self.inner(x, adj, generator=generator)

    data = stochastic_block_model(num_nodes=64, num_classes=3, seed=5)
    cfg = _fit_cfg("encoder_gcn", num_parts=8)
    cfg.train.epochs = 1
    with pytest.raises(ValueError, match="mask"):
        fit(cfg, data, model=NoMaskEncoder(EncoderGCN(16, 3)), device="cpu", verbose=False)


def _dp_cfg(**train):
    return Config.from_dict({
        "model": {"name": "sage", "hidden": 16, "dropout": 0.0},
        "train": {"batch_size": 32, "fanouts": [4, 3], **train},
        "dist": {"num_parts": 4},
    })


def test_dp_sampled_gradients_equal_the_serial_mean():
    """One data-parallel step's loss and gradients equal the mean over the
    parts of the per-part losses, each sampled with that part's generator."""
    data = stochastic_block_model(num_nodes=300, num_classes=3, seed=0)
    cfg = _dp_cfg()
    model = GraphSAGE(data.num_features, 16, 3, dropout=0.0, generator=torch.Generator().manual_seed(0))
    step = build_step(cfg, data, model, CPU)
    assert len(step.sample_gens) == 4 and step.hop_adjs[-1].num_dst_nodes == 8  # 32 seeds over 4 parts
    gen_states = [g.get_state() for g in step.sample_gens]
    rng_state = step.rng_np.bit_generator.state
    loss = step.loss()
    loss.backward()
    dp = {n: p.grad.clone() for n, p in model.named_parameters()}

    model.zero_grad()
    step.rng_np.bit_generator.state = rng_state
    seeds = step.rng_np.choice(np.nonzero(data.train_mask.numpy())[0], 32)
    sampler = NeighborSampler(data, [4, 3])
    losses = []
    for p, part in enumerate(np.split(seeds, 4)):
        gen = torch.Generator().set_state(gen_states[p])
        nodes, adjs = sampler.sample(gen, torch.from_numpy(part))
        losses.append(cross_entropy(model.forward_sampled(data.x[nodes], adjs), data.y[torch.from_numpy(part)]))
    serial = torch.stack(losses).mean()
    serial.backward()
    assert abs(loss.item() - serial.item()) < 1e-6
    for n, p in model.named_parameters():
        torch.testing.assert_close(dp[n], p.grad, rtol=2e-4, atol=1e-6)


def test_fit_dp_sampled_learns():
    data = stochastic_block_model(num_nodes=300, num_classes=3, seed=4)
    _, _, hist = fit(_dp_cfg(epochs=40, eval_every=40), data, device="cpu", verbose=False)
    assert hist[-1]["test_acc"] > 0.7


def test_fit_dp_sampled_batch_divisibility_error():
    data = stochastic_block_model(num_nodes=100, num_classes=2, seed=5)
    cfg = Config.from_dict({"train": {"epochs": 1, "batch_size": 30}, "dist": {"num_parts": 4}})
    with pytest.raises(ValueError, match="divide evenly"):
        fit(cfg, data, device="cpu", verbose=False)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_dryrun_multichip_on_cpu_parts(n_parts):
    """The dry run's first half (fit of gcn, local_blocked=8 and encoder_gcn,
    a distributed GAT and GIN loss and gradient) on parts of the CPU."""
    from gnn_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(n_parts, device="cpu")


def test_fit_across_processes_waits_for_item_15(monkeypatch, tmp_path):
    """Ported (the test keeps its earlier name): ``fit`` in a
    torch.distributed group runs the group path, every loss, statistic and
    gradient sum an all-reduce, and in a gloo group of one process that path
    equals the in-process 4-part ``fit`` bit for bit (losses, accuracies,
    parameters, BatchNorm buffers); a part count that does not divide over
    the group's processes raises. Two processes: tests/test_torch_group_fit.py."""
    import torch.distributed as tdist

    from gnn_tpu_torch.parallel import multihost

    data = stochastic_block_model(num_nodes=96, num_classes=3, seed=6)
    cfg = _fit_cfg("encoder_gcn", num_parts=4)
    keys = ("loss", "train_acc", "val_acc", "test_acc")
    model_a, state_a, want = fit(cfg, data, device="cpu", verbose=False)
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        model_b, state_b, got = fit(cfg, data, device="cpu", verbose=False)
        assert [[h[k] for k in keys] for h in got] == [[h[k] for k in keys] for h in want]
        for (name, a), b in zip(model_a.named_parameters(), model_b.parameters()):
            assert torch.equal(a, b), name
        assert all(torch.equal(state_a[k], state_b[k]) for k in state_a)
        assert all(m.process_group is None for m in model_b.modules() if hasattr(m, "process_group"))
        monkeypatch.setattr(multihost, "process_count", lambda: 3)
        with pytest.raises(ValueError, match="divide evenly over the 3 processes"):
            fit(cfg, data, device="cpu", verbose=False)
    finally:
        tdist.destroy_process_group()
