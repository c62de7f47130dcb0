"""The port's ``Checkpointer`` and ``fit(resume=True)``.

Stop-and-resume is compared bit for bit on the CPU: ``fit`` saves, beside
parameters, optimizer state and buffers, the position of every random stream
(dropout, sampler, the numpy seed draw, the host loader's seed), so a run
that stops at epoch k and resumes sees the losses, accuracies and final
parameters of an uninterrupted run exactly. Where no randomness is involved
the resumed loss curve also equals ``gnn_tpu.train.fit``'s resumed curve at
rtol=1e-4 (float32 sums in another order, compounding over the epochs).
"""

import os

import jax
import numpy as np
import pytest
import torch

from gnn_tpu import nn as jnn
from gnn_tpu.graphs.datasets import load_dataset as jax_load_dataset
from gnn_tpu.models import GCN as JaxGCN
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu_torch.graphs import Data, load_dataset
from gnn_tpu_torch.models import GCN, EncoderGCN
from gnn_tpu_torch.nn import buffer_state, load_jax_state_dict
from gnn_tpu_torch.optim import Adam
from gnn_tpu_torch.train import Checkpointer, Config, fit


def _cfg(**over):
    cfg = Config.from_dict(
        {
            "dataset": "sbm",
            "model": {"name": "gcn", "hidden": 16, "dropout": 0.5},
            "optim": {"lr": 0.01},
            "train": {"epochs": 6, "eval_every": 1},
        }
    )
    return cfg.apply_overrides([f"{k}={v}" for k, v in over.items()])


def _stepped(model, opt, data, adj, steps=2):
    for _ in range(steps):
        opt.zero_grad()
        model(data.x, adj).sum().backward()
        opt.step()


def test_checkpointer_round_trip(tmp_path):
    """Parameters, optimizer moments, buffers and ``extra`` come back
    exactly, into objects made anew."""
    data = load_dataset("karate")
    adj = data.to_adjacency(norm="sym")
    model = EncoderGCN(data.num_features, 2, num_layers=2, generator=torch.Generator().manual_seed(0))
    opt = Adam(model.parameters(), lr=0.01)
    _stepped(model, opt, data, adj)
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.latest_step() is None
    extra = {"gen": torch.Generator().manual_seed(5).get_state(), "note": "x", "nums": [1, 2.5]}
    ckpt.save(2, model, opt, buffer_state(model), extra)
    assert ckpt.latest_step() == 2 and os.listdir(tmp_path) == ["step_2.pt"]

    fresh = EncoderGCN(data.num_features, 2, num_layers=2, generator=torch.Generator().manual_seed(9))
    fresh_opt = Adam(fresh.parameters(), lr=0.01)
    got_model, got_opt, got_state, got_extra = Checkpointer(str(tmp_path)).restore(
        fresh, fresh_opt, buffer_state(fresh)
    )
    assert got_model is fresh and got_opt is fresh_opt
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name
    for (name, b), c in zip(model.named_buffers(), fresh.buffers()):
        assert torch.equal(b, c) and torch.equal(got_state[name], b), name
    want, got = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    assert want.keys() == got.keys() and len(want) > 0
    for k in want:
        for field, v in want[k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(got[k][field])), (k, field)
    assert torch.equal(got_extra["gen"], extra["gen"]) and got_extra["note"] == "x" and got_extra["nums"] == [1, 2.5]
    # both continue identically
    _stepped(model, opt, data, adj)
    _stepped(fresh, fresh_opt, data, adj)
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
    ckpt.close()


def test_checkpointer_prunes_to_max_to_keep(tmp_path):
    model = GCN(4, 4, 2)
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.max_to_keep == 3
    for step in (1, 2, 3, 10, 4):
        ckpt.save(step, model)
    assert ckpt.all_steps() == [3, 4, 10] and ckpt.latest_step() == 10
    assert sorted(os.listdir(tmp_path)) == ["step_10.pt", "step_3.pt", "step_4.pt"]
    two = Checkpointer(str(tmp_path / "two"), max_to_keep=2)
    for step in range(5):
        two.save(step, model)
    assert two.all_steps() == [3, 4]


def test_checkpointer_restores_a_subset_and_a_chosen_step(tmp_path):
    """The model alone (for inference), an older step, and the errors."""
    gen = torch.Generator().manual_seed(0)
    model = GCN(4, 4, 2, generator=gen)
    opt = Adam(model.parameters(), lr=0.1)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, model, opt)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ckpt.save(2, model, opt, extra={"epoch": 2})

    fresh = GCN(4, 4, 2)
    got, got_opt, got_state, extra = ckpt.restore(fresh)
    assert got_opt is None and got_state is None and extra == {"epoch": 2}
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in fresh.state_dict().items())
    _, _, _, extra = ckpt.restore(fresh, step=1)
    assert extra is None and all(torch.equal(v, first[k]) for k, v in fresh.state_dict().items())

    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(GCN(4, 8, 2))
    with pytest.raises(KeyError, match="lacks parameters"):
        ckpt.restore(GCN(4, 4, 2, num_layers=3))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Checkpointer(str(tmp_path / "empty")).restore(fresh)


def test_checkpoint_files_hold_tensors_only(tmp_path):
    """Read back with ``weights_only=True``: no pickled code."""
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, GCN(4, 4, 2), Adam(GCN(4, 4, 2).parameters(), lr=0.1), extra={"s": "text"})
    payload = torch.load(tmp_path / "step_1.pt", weights_only=True)
    assert set(payload) == {"step", "model", "opt_state", "extra"} and payload["step"] == 1
    assert list(payload["model"]) == [name for name, _ in GCN(4, 4, 2).named_parameters()]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def _host_data(data: Data) -> Data:
    return Data(
        x=data.x.numpy(), edge_index=data.edge_index.numpy(), y=data.y.numpy(), num_nodes=data.num_nodes,
        train_mask=data.train_mask.numpy(), val_mask=data.val_mask.numpy(), test_mask=data.test_mask.numpy(),
        host_arrays=True,
    )


RESUME_CASES = {
    "gcn-dropout": {},
    "encoder_gcn-buffers": {"model.name": "encoder_gcn"},
    "sage-sampled": {"model.name": "sage", "train.batch_size": 32, "train.fanouts": "[3,3]"},
    "gat-sampled": {"model.name": "gat", "model.heads": 2, "train.batch_size": 32, "train.fanouts": "[3,3]"},
    "sage-host": {"model.name": "sage", "train.batch_size": 32, "train.fanouts": "[3,3]",
                  "train.host_features": True},
    "sgd-momentum-clip": {"optim.name": "sgd", "optim.grad_clip": 0.5},
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_stop_and_resume_equals_uninterrupted_bit_for_bit(tmp_path, case):
    over = RESUME_CASES[case]
    data = load_dataset("sbm", num_nodes=120, seed=4)
    if over.get("train.host_features"):
        data = _host_data(data)
    keys = ("loss", "train_acc", "val_acc", "test_acc")

    model_a, state_a, whole = fit(_cfg(**over), data, device="cpu", verbose=False)

    stop = {**over, "train.checkpoint_dir": str(tmp_path / "ckpt"), "train.checkpoint_every": 2}
    _, _, head = fit(_cfg(**{**stop, "train.epochs": 4}), data, device="cpu", verbose=False)
    assert Checkpointer(stop["train.checkpoint_dir"]).all_steps() == [2, 4]
    model_b, state_b, tail = fit(_cfg(**stop), data, device="cpu", resume=True, verbose=False)
    assert len(head) == 4 and len(tail) == 2
    for got, want in zip(head + tail, whole):
        assert [got[k] for k in keys] == [want[k] for k in keys]
    for (name, p), q in zip(model_a.named_parameters(), model_b.parameters()):
        assert torch.equal(p, q), name
    assert (state_a is None) == (state_b is None) == (case != "encoder_gcn-buffers")
    if state_a is not None:
        assert all(torch.equal(state_a[k], state_b[k]) for k in state_a)
    assert Checkpointer(stop["train.checkpoint_dir"]).all_steps() == [2, 4, 6]


def test_resume_without_a_checkpoint_starts_from_scratch(tmp_path):
    cfg = _cfg(**{"train.checkpoint_dir": str(tmp_path / "none"), "train.epochs": 3})
    data = load_dataset("karate")
    _, _, a = fit(cfg, data, device="cpu", resume=True, verbose=False)
    _, _, b = fit(_cfg(**{"train.epochs": 3}), data, device="cpu", verbose=False)
    assert [h["loss"] for h in a] == [h["loss"] for h in b] and len(a) == 3
    # past the last epoch there is nothing left to run
    _, _, again = fit(cfg, data, device="cpu", resume=True, verbose=False)
    assert again == []


def test_resumed_curve_equals_the_jax_resumed_curve(tmp_path):
    """Full graph, dropout 0 (no randomness, where the JAX ``fit``'s re-made
    streams cannot matter): stop at 3 of 6 epochs in both packages, resume
    both, and the 6 losses agree."""
    jdata, tdata = jax_load_dataset("sbm"), load_dataset("sbm")
    jmodel = JaxGCN(tdata.num_features, 16, 4, key=jax.random.PRNGKey(2), dropout=0.0)
    weights = {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()}

    def cfg(pkg, epochs):
        return _cfg(**{"model.dropout": 0.0, "train.epochs": epochs, "train.checkpoint_every": 3,
                       "train.checkpoint_dir": str(tmp_path / pkg)})

    jlosses, tlosses = [], []
    for epochs, resume in ((3, False), (6, True)):
        _, _, jhist = jax_fit(JaxConfig.from_json(cfg("jax", epochs).to_json()), jdata,
                              model=jmodel, resume=resume, verbose=False)
        tmodel = load_jax_state_dict(GCN(tdata.num_features, 16, 4, dropout=0.0), weights)
        _, _, thist = fit(cfg("torch", epochs), tdata, model=tmodel, device="cpu", resume=resume, verbose=False)
        jlosses += [h["loss"] for h in jhist]
        tlosses += [h["loss"] for h in thist]
    assert len(tlosses) == len(jlosses) == 6
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
