"""The port's training loops (full graph, sampled minibatches, host
features), config and CLI.

Loss parity: with dropout 0 and the same initial weights, the port's ``fit``
and ``gnn_tpu.train.fit`` see the same losses to rtol=1e-4 (float32 sums in
another order compound over the epochs). The JAX run relabels nodes
(``reorder='auto'``); the masked-mean loss does not depend on node order.
"""

import jax
import numpy as np
import pytest
import torch

from gnn_tpu import nn as jnn
from gnn_tpu.graphs.datasets import load_dataset as jax_load_dataset
from gnn_tpu.models import GCN as JaxGCN
from gnn_tpu.models import GIN as JaxGIN
from gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from gnn_tpu.graphs.data import Data as JaxData
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu_torch.graphs import Data, cora_like, load_dataset
from gnn_tpu_torch.models import GCN, GIN, GraphSAGE
from gnn_tpu_torch.nn import load_jax_state_dict
from gnn_tpu_torch.train import Checkpointer, Config, fit
from gnn_tpu_torch.train.cli import main, parse_args
from gnn_tpu_torch.train.loop import build_model


def _cfg(**over):
    cfg = Config.from_dict(
        {
            "dataset": "sbm",
            "model": {"name": "gcn", "hidden": 16, "dropout": 0.0},
            "optim": {"lr": 0.01},
            "train": {"epochs": 5, "eval_every": 1},
        }
    )
    return cfg.apply_overrides([f"{k}={v}" for k, v in over.items()])


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_fit_losses_match_jax(weight_decay):
    jdata, tdata = jax_load_dataset("sbm"), load_dataset("sbm")
    jcfg = JaxConfig.from_json(_cfg(**{"optim.weight_decay": weight_decay}).to_json())
    jmodel = JaxGCN(tdata.num_features, 16, 4, key=jax.random.PRNGKey(2), dropout=0.0)
    tmodel = load_jax_state_dict(
        GCN(tdata.num_features, 16, 4, dropout=0.0),
        {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()},
    )
    _, _, jhist = jax_fit(jcfg, jdata, model=jmodel, verbose=False)
    _, state, thist = fit(
        _cfg(**{"optim.weight_decay": weight_decay}), tdata, model=tmodel, device="cpu", verbose=False
    )
    assert state is None and len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    for split in ("train_acc", "val_acc", "test_acc"):
        assert abs(thist[-1][split] - jhist[-1][split]) <= 0.01, split


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("gcn", {"optim.name": "sgd", "optim.lr": 0.1, "optim.grad_clip": 0.5}),
        ("gcn", {"optim.name": "sgd", "optim.lr": 0.1, "optim.momentum": 0.0, "optim.weight_decay": 5e-4}),
        ("gcn", {"optim.name": "adamw", "optim.grad_clip": 0.5}),
        ("sage", {}),
        ("sage", {"model.aggr": "sum", "optim.name": "sgd", "optim.grad_clip": 1.0}),
        ("sage", {"model.aggr": "max"}),
        ("gin", {}),
        ("gin", {"model.num_layers": 3, "optim.name": "sgd", "optim.lr": 0.01, "optim.grad_clip": 1.0}),
    ],
    ids=lambda v: v if isinstance(v, str) else ",".join(f"{k.split('.')[1]}={x}" for k, x in v.items()) or "adam",
)
def test_fit_losses_match_jax_by_model_and_optimizer(name, overrides):
    """The 5-epoch loss curve at rtol=1e-4 for GraphSAGE and GIN, and for the
    GCN under SGD and gradient clipping; dropout 0, weights carried over.
    Both ``fit``s hand the gcn_norm weights to the model."""
    cfg = _cfg(**{"model.name": name, **overrides})
    m = cfg.model
    jdata, tdata = jax_load_dataset("sbm"), load_dataset("sbm")
    F, key = tdata.num_features, jax.random.PRNGKey(2)
    if name == "gcn":
        jmodel, tmodel = JaxGCN(F, 16, 4, key=key, dropout=0.0), GCN(F, 16, 4, dropout=0.0)
    elif name == "sage":
        jmodel = JaxGraphSAGE(F, 16, 4, key=key, aggr=m.aggr, dropout=0.0)
        tmodel = GraphSAGE(F, 16, 4, aggr=m.aggr, dropout=0.0)
    else:
        jmodel = JaxGIN(F, 16, 4, key=key, num_layers=m.num_layers)
        tmodel = GIN(F, 16, 4, num_layers=m.num_layers)
    load_jax_state_dict(tmodel, {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()})
    _, _, jhist = jax_fit(JaxConfig.from_json(cfg.to_json()), jdata, model=jmodel, verbose=False)
    _, state, thist = fit(cfg, tdata, model=tmodel, device="cpu", verbose=False)
    assert state is None and len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    assert thist[-1]["loss"] < thist[0]["loss"]
    for split in ("train_acc", "val_acc", "test_acc"):
        assert abs(thist[-1][split] - jhist[-1][split]) <= 0.01, split


@pytest.mark.parametrize("name", ["gcn", "gat", "encoder_gcn", "sage", "gin"])
@pytest.mark.parametrize("optimizer,clip", [("adam", 0.0), ("adamw", 1.0), ("sgd", 0.0), ("sgd", 1.0)])
def test_fit_trains_every_model_with_every_optimizer(name, optimizer, clip):
    """Built from the config alone (the port's own initial weights)."""
    cfg = _cfg(**{"model.name": name, "model.dropout": 0.3, "optim.name": optimizer, "optim.grad_clip": clip,
                  "train.epochs": 3, "model.heads": 2})
    model, state, hist = fit(cfg, load_dataset("karate"), device="cpu", verbose=False)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert (state is not None) == (name == "encoder_gcn")
    assert model.training


@pytest.mark.parametrize("name", ["encoder_gcn", "sage", "gin"])
def test_fit_on_the_blocked_layout_matches_the_csr(name):
    """``train.reorder='cluster'`` with the new models: the same losses as on
    the CSR at rtol=1e-4 (the relabelling is exact; the blocked product sums
    in another order). GIN drops the weights of the blocked layouts too."""
    hists = []
    for reorder in ("auto", "cluster"):
        cfg = _cfg(**{"model.name": name, "train.reorder": reorder})
        _, _, hist = fit(cfg, load_dataset("sbm"), device="cpu", verbose=False)
        hists.append([h["loss"] for h in hist])
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-4)


def test_cora_like_kipf_accuracy_band():
    """The main-path done bar: the Kipf recipe of
    tests/test_models.py::test_cora_like_gcn_accuracy_band through the port."""
    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.dropout = "gcn", 16, 0.5
    cfg.optim.lr, cfg.optim.weight_decay = 0.01, 5e-4
    cfg.train.epochs, cfg.train.eval_every = 200, 200
    _, _, hist = fit(cfg, cora_like(seed=0), device="cpu", verbose=False)
    acc = hist[-1]["test_acc"]
    assert 0.78 <= acc <= 0.88, f"outside Cora band: {acc}"


def test_cli_main_runs_on_cpu(capsys):
    assert main(["--dataset", "sbm", "--device", "cpu", "--train.epochs", "20"]) == 0
    assert "final:" in capsys.readouterr().out


@pytest.mark.parametrize(
    "flags",
    [
        ["--model.name", "encoder_gcn"],
        ["--model.name", "sage", "--model.aggr", "max"],
        ["--model.name", "gin"],
        ["--optim.name", "sgd", "--optim.grad_clip", "1.0"],
    ],
    ids=lambda f: "_".join(f[1::2]),
)
def test_cli_main_trains_the_other_models_and_optimizers(capsys, flags):
    assert main(["--dataset", "sbm", "--device", "cpu", "--train.epochs", "30", "--optim.lr", "0.02", *flags]) == 0
    out = capsys.readouterr().out
    assert "final:" in out
    assert float(out.split("test_acc=")[1].split()[0]) > 0.8


def test_cli_parse_and_config_round_trip():
    cfg, device = parse_args(["--dataset", "karate", "--optim.lr", "0.005", "--train.fanouts", "[3,3]"])
    assert (cfg.dataset, cfg.optim.lr, cfg.train.fanouts, device) == ("karate", 0.005, [3, 3], "cuda")
    assert Config.from_json(cfg.to_json()) == cfg
    # the JAX package reads the same config file
    assert JaxConfig.from_json(cfg.to_json()).optim.lr == 0.005
    with pytest.raises(ValueError):
        cfg.apply_overrides(["bogus.key=1"])


def test_fit_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(_cfg(), load_dataset("karate"), device="cuda", verbose=False)


@pytest.mark.parametrize(
    "override",
    [
        {"train.batch_size": 64},
        {"dist.num_parts": 2},
        {"train.host_features": True},
        {"train.checkpoint_dir": "ckpt"},
        {"train.reorder": "true"},
        {"model.name": "gat", "train.batch_size": 64},
        pytest.param({"model.name": "sage", "train.batch_size": 64}, id="sage,train.batch_size=64"),
        pytest.param({"model.name": "gin", "train.batch_size": 64}, id="gin,train.batch_size=64"),
        pytest.param({"model.name": "encoder_gcn", "dist.num_parts": 2}, id="encoder_gcn,dist.num_parts=2"),
        pytest.param({"model.name": "sage", "dist.num_parts": 2}, id="sage,dist.num_parts=2"),
    ],
    ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values()))),
)
def test_unported_branches_raise(override, tmp_path):
    """What has been ported does what the JAX ``fit`` does: ``dist.num_parts``
    trains the partitioned graph to the single-device loss curve, sampled
    minibatches train (a model without ``forward_sampled`` is refused),
    ``host_features`` alone hits the JAX guard, ``checkpoint_dir`` writes
    the final checkpoint, ``train.reorder='true'`` relabels and trains to
    the JAX loss curve (rtol=1e-4)."""
    if "dist.num_parts" in override:
        # ported: the partitioned fit trains to the single-device loss curve
        data = load_dataset("karate")
        gen = lambda: torch.Generator().manual_seed(3)
        cfg = _cfg(**override)
        one = build_model(cfg, data.num_features, int(data.y.max()) + 1, gen())
        parts = build_model(cfg, data.num_features, int(data.y.max()) + 1, gen())
        _, _, want = fit(_cfg(**{k: v for k, v in override.items() if k != "dist.num_parts"}), data,
                         model=one, device="cpu", verbose=False)
        _, _, got = fit(cfg, data, model=parts, device="cpu", verbose=False)
        np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want], rtol=1e-4)
    elif "train.reorder" in override:
        jdata, tdata = jax_load_dataset("sbm"), load_dataset("sbm")
        jmodel = JaxGCN(tdata.num_features, 16, 4, key=jax.random.PRNGKey(2), dropout=0.0)
        tmodel = load_jax_state_dict(
            GCN(tdata.num_features, 16, 4, dropout=0.0),
            {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()},
        )
        _, _, jhist = jax_fit(JaxConfig.from_json(_cfg(**override).to_json()), jdata, model=jmodel, verbose=False)
        _, _, thist = fit(_cfg(**override), tdata, model=tmodel, device="cpu", verbose=False)
        np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    elif override == {"train.host_features": True}:
        with pytest.raises(ValueError, match="train.host_features requires batch_size > 0"):
            fit(_cfg(**override), load_dataset("karate"), device="cpu", verbose=False)
    elif override == {"train.batch_size": 64}:  # the default gcn has no forward_sampled
        with pytest.raises(ValueError, match="forward_sampled"):
            fit(_cfg(**override), load_dataset("sbm"), device="cpu", verbose=False)
    elif "train.checkpoint_dir" in override:
        cfg = _cfg(**{"train.checkpoint_dir": str(tmp_path / "ckpt")})
        _, _, hist = fit(cfg, load_dataset("karate"), device="cpu", verbose=False)
        assert len(hist) == 5 and Checkpointer(cfg.train.checkpoint_dir).all_steps() == [5]
    else:
        cfg = _cfg(**{**override, "train.fanouts": "[3,3]", "model.heads": 2})
        _, state, hist = fit(cfg, load_dataset("sbm"), device="cpu", verbose=False)
        assert state is None and len(hist) == 5 and all(np.isfinite(h["loss"]) for h in hist)
        assert hist[-1]["loss"] < hist[0]["loss"]


def test_early_stopping_restores_best():
    cfg = _cfg(**{"train.epochs": 60, "train.patience": 2, "optim.lr": 0.5})
    model, _, hist = fit(cfg, load_dataset("sbm"), device="cpu", verbose=False)
    assert len(hist) < 60
    best = max(h["val_acc"] for h in hist)
    assert all(np.isfinite(h["loss"]) and h["step_ms"] > 0 for h in hist)
    assert best >= hist[-1]["val_acc"]


@pytest.mark.parametrize("field,value", [("model.name", "mlp"), ("optim.name", "lion")])
def test_unknown_model_and_optimizer_raise(field, value):
    with pytest.raises(ValueError, match="unknown"):
        fit(_cfg(**{field: value}), load_dataset("karate"), device="cpu", verbose=False)


def _host_arrays(data, cls):
    """``data``'s arrays as a host-resident ``Data`` of either package."""
    fields = {k: np.asarray(getattr(data, k)) for k in ("x", "edge_index", "y", "train_mask", "val_mask", "test_mask")}
    return cls(num_nodes=data.num_nodes, host_arrays=True, **fields)


@pytest.mark.parametrize("aggr", ["mean", "max"])
def test_fit_host_features_losses_match_jax(aggr):
    """``train.host_features`` on ``Data(host_arrays=True)``: both packages
    draw the same seed batches (numpy's ``default_rng(seed).choice``) and the
    same neighbours (one C++ source, one seed schedule, the evaluation's
    batches between the steps included), so with dropout 0 and carried-over
    weights the 5-step loss curve agrees at rtol=1e-4 and the
    neighbour-sampled accuracies of every split (whose last chunk is padded
    with node 0) within one node of 250."""
    over = {"model.name": "sage", "model.aggr": aggr, "train.batch_size": 32, "train.fanouts": "[4,3]",
            "train.host_features": True}
    cfg = _cfg(**over)
    tdata = load_dataset("sbm", num_nodes=250, seed=6)
    F = tdata.num_features
    jmodel = JaxGraphSAGE(F, 16, 4, key=jax.random.PRNGKey(2), aggr=aggr, dropout=0.0)
    tmodel = GraphSAGE(F, 16, 4, aggr=aggr, dropout=0.0)
    load_jax_state_dict(tmodel, {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()})
    _, _, jhist = jax_fit(JaxConfig.from_json(cfg.to_json()), _host_arrays(tdata, JaxData), model=jmodel, verbose=False)
    _, state, thist = fit(cfg, _host_arrays(tdata, Data), model=tmodel, device="cpu", verbose=False)
    assert state is None and len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    for h, jh in zip(thist, jhist):
        for split in ("train_acc", "val_acc", "test_acc"):
            assert abs(h[split] - jh[split]) <= 1 / 250 + 1e-9, split
        assert h["host_batch_ms"] > 0 and h["host_copy_ms"] >= 0 and h["step_ms"] > h["host_batch_ms"]


def test_fit_host_features_takes_device_resident_data_too():
    """The loader reads a tensor-held ``Data`` through numpy views, as the
    JAX ``fit`` does (``np.asarray(data.x)``)."""
    cfg = _cfg(**{"model.name": "sage", "train.batch_size": 32, "train.fanouts": "[4,3]", "train.host_features": True})
    data = load_dataset("sbm", num_nodes=250, seed=6)
    _, _, a = fit(cfg, data, device="cpu", verbose=False)
    _, _, b = fit(cfg, _host_arrays(data, Data), device="cpu", verbose=False)
    assert [h["loss"] for h in a] == [h["loss"] for h in b]


@pytest.mark.parametrize("name,bar", [("sage", 0.8), ("gat", 0.75), ("gin", 0.75)])
def test_fit_sampled_learns_to_the_jax_bars(name, bar):
    """Device-sampled minibatches with the recipe and the bars of
    tests/test_train.py::test_fit_sampled_learns and
    test_fit_sampled_gat_gin_learn (the draws differ: another generator)."""
    cfg = Config.from_dict({"dataset": "sbm", "model": {"hidden": 16, "dropout": 0.1}, "optim": {"lr": 0.02},
                            "train": {"epochs": 120, "eval_every": 10}})
    cfg = cfg.apply_overrides([f"model.name={name}", "model.heads=2", "train.batch_size=64", "train.fanouts=[4,4]"])
    data = load_dataset("sbm", num_nodes=250, seed=6)
    _, state, hist = fit(cfg, data, device="cpu", verbose=False)
    assert state is None and len(hist) == 12
    assert hist[-1]["test_acc"] > bar and hist[-1]["loss"] < hist[0]["loss"]
    # reorder='cluster' is forced off for sampled batches, as in the JAX fit:
    # the same run, node ids kept
    if name == "sage":
        cfg.train.reorder = "cluster"
        _, _, again = fit(cfg, data, device="cpu", verbose=False)
        assert [h["loss"] for h in again] == [h["loss"] for h in hist]


@pytest.mark.parametrize(
    "override,match",
    [
        ({"train.host_features": True}, "train.host_features requires batch_size > 0"),
        ({"train.batch_size": 30, "dist.num_parts": 4}, "must divide evenly"),
        ({"train.batch_size": 32, "dist.num_parts": 4, "train.host_features": True},
         "train.host_features is the single-process host-gather path"),
    ],
    ids=["host_features-without-batches", "batch-not-divisible", "host_features-with-parts"],
)
def test_sampled_guards_raise_what_jax_raises(override, match):
    cfg = _cfg(**{"model.name": "sage", **override})
    data = load_dataset("sbm")
    with pytest.raises(ValueError, match=match):
        fit(cfg, data, device="cpu", verbose=False)
    with pytest.raises(ValueError, match=match):
        jax_fit(JaxConfig.from_json(cfg.to_json()), jax_load_dataset("sbm"), verbose=False)


def test_data_parallel_sampling_waits_for_the_parallel_item():
    """Ported since: data-parallel sampling trains (tests/test_torch_dist_models.py
    holds its gradients to the serial mean)."""
    cfg = _cfg(**{"model.name": "sage", "train.batch_size": 32, "dist.num_parts": 4})
    _, _, hist = fit(cfg, load_dataset("sbm"), device="cpu", verbose=False)
    assert len(hist) == 5 and all(np.isfinite(h["loss"]) for h in hist)
    with pytest.raises(ValueError, match="train_mask"):
        fit(_cfg(**{"model.name": "sage", "train.batch_size": 8}), load_dataset("karate"), device="cpu", verbose=False)


@pytest.mark.parametrize(
    "flags",
    [
        ["--model.name", "sage"],
        ["--model.name", "gat", "--model.heads", "2"],
        ["--model.name", "gin"],
        ["--model.name", "sage", "--train.host_features", "true"],
    ],
    ids=["sage", "gat", "gin", "sage-host_features"],
)
def test_cli_main_trains_on_sampled_minibatches(capsys, flags):
    argv = ["--dataset", "sbm", "--device", "cpu", "--train.epochs", "60", "--optim.lr", "0.02",
            "--train.batch_size", "64", "--train.fanouts", "[4,4]", *flags]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "final:" in out and float(out.split("test_acc=")[1].split()[0]) > 0.75
