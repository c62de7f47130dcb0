"""Worker of tests/test_torch_group_fit.py: one of two processes of a gloo
group on the CPU. Each runs ``fit`` with ``dist.num_parts=4``, holding 2 of
the 4 parts (or, data-parallel sampled, 2 of the 4 parts' seeds), and checks
its loss curve and accuracies against the references it was handed, its
final parameters and buffers against the other process's bit for bit, and a
run stopped at a checkpoint and resumed against an uninterrupted one bit for
bit. Imports no JAX (checked at the end), so that it runs where only torch
is installed."""

import sys

import numpy as np
import torch
import torch.distributed as tdist

from gnn_tpu_torch.graphs import stochastic_block_model
from gnn_tpu_torch.nn import load_jax_state_dict
from gnn_tpu_torch.parallel import multihost
from gnn_tpu_torch.train import Config, fit
from gnn_tpu_torch.train.loop import build_model

ACCURACIES = ("train_acc", "val_acc", "test_acc")


def data_of(case: dict):
    return stochastic_block_model(num_nodes=case["nodes"], num_classes=3, seed=case["seed"])


def model_of(cfg: Config, data, params):
    """fit's own initial model, or the one that carries ``params``."""
    model = build_model(cfg, data.num_features, 3, torch.Generator().manual_seed(cfg.train.seed))
    return model if params is None else load_jax_state_dict(model, params)


def same_on_every_process(tensors, label: str) -> None:
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    gathered = [torch.empty_like(flat) for _ in range(tdist.get_world_size())]
    tdist.all_gather(gathered, flat)
    if not all(torch.equal(g, gathered[0]) for g in gathered):
        raise AssertionError(f"{label}: parameters or buffers differ between the processes")


def tensors_of(model, state) -> list:
    return list(model.parameters()) + ([] if state is None else list(state.values()))


def check_curves(case: dict, history: list, name: str) -> None:
    losses = [h["loss"] for h in history]
    want = case["one_process"]
    np.testing.assert_allclose(losses, [h["loss"] for h in want], rtol=1e-6, err_msg=f"{name} vs one process")
    for got, ref in zip(history, want):
        for split in ACCURACIES:
            np.testing.assert_allclose(got[split], ref[split], atol=1e-6, err_msg=f"{name} {split}")
    if case["reference"] is not None:
        np.testing.assert_allclose(losses, case["reference"], rtol=1e-4, err_msg=f"{name} vs gnn_tpu.train.fit")


def check_resume(case: dict, directory: str, name: str) -> None:
    """Stop at epoch 4 (checkpoints at 2 and 4), resume to 6: the losses,
    accuracies, parameters and buffers of an uninterrupted run, bit for bit."""
    data = data_of(case)
    cfg = Config.from_dict(case["cfg"])
    model_a, state_a, whole = fit(cfg, data, model=model_of(cfg, data, None), device="cpu", verbose=False)
    stop = Config.from_dict(case["cfg"])
    stop.train.checkpoint_dir, stop.train.checkpoint_every = directory, 2
    stop.train.epochs = 4
    _, _, head = fit(stop, data, model=model_of(stop, data, None), device="cpu", verbose=False)
    stop.train.epochs = cfg.train.epochs
    model_b, state_b, tail = fit(stop, data, model=model_of(stop, data, None), device="cpu", resume=True,
                                 verbose=False)
    keys = ("loss",) + ACCURACIES
    if len(head) + len(tail) != len(whole) or any(
        [g[k] for k in keys] != [w[k] for k in keys] for g, w in zip(head + tail, whole)
    ):
        raise AssertionError(f"{name}: the resumed run's curve {head + tail} differs from {whole}")
    for a, b in zip(tensors_of(model_a, state_a), tensors_of(model_b, state_b)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: the resumed run's parameters or buffers differ")
    same_on_every_process(tensors_of(model_b, state_b), f"{name} resumed")


def run(rank: int, store: str, cases: dict, resume_cases: dict, directory: str) -> None:
    torch.set_num_threads(1)  # graphs of a few hundred nodes: threads would only contend for the cores
    multihost.initialize(store, 2, rank, device="cpu")
    for name, case in cases.items():
        data = data_of(case)
        cfg = Config.from_dict(case["cfg"])
        model, state, history = fit(cfg, data, model=model_of(cfg, data, case["params"]), device="cpu",
                                    verbose=False)
        check_curves(case, history, name)
        same_on_every_process(tensors_of(model, state), name)
    for name, case in resume_cases.items():
        check_resume(case, f"{directory}/{name}", name)
    assert not any(name == "jax" or name.startswith("jax.") for name in sys.modules)
    tdist.destroy_process_group()
