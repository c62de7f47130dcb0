"""The port's full-graph training loop, config and CLI.

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
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu_torch.graphs import cora_like, load_dataset
from gnn_tpu_torch.models import GCN
from gnn_tpu_torch.nn import load_jax_state_dict
from gnn_tpu_torch.train import Config, fit
from gnn_tpu_torch.train.cli import main, parse_args


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
        {"model.name": "sage"},
        {"model.name": "encoder_gcn"},
        {"optim.name": "sgd"},
        {"optim.grad_clip": 1.0},
    ],
    ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values()))),
)
def test_unported_branches_raise(override):
    with pytest.raises(NotImplementedError):
        fit(_cfg(**override), load_dataset("karate"), device="cpu", verbose=False)


def test_early_stopping_restores_best():
    cfg = _cfg(**{"train.epochs": 60, "train.patience": 2, "optim.lr": 0.5})
    model, _, hist = fit(cfg, load_dataset("sbm"), device="cpu", verbose=False)
    assert len(hist) < 60
    best = max(h["val_acc"] for h in hist)
    assert all(np.isfinite(h["loss"]) and h["step_ms"] > 0 for h in hist)
    assert best >= hist[-1]["val_acc"]
