"""``fit`` across processes: two processes of a gloo group on the CPU, each
holding 2 of ``dist.num_parts=4`` parts (``tests/torch_group_fit_worker.py``,
a ``file://`` store in ``tmp_path``, 120 s at most, one spawn for the file).

Full graph, dropout 0, 6 epochs: ``gcn`` and ``gat`` under Adam and
``encoder_gcn`` under SGD (under Adam its ``pre`` bias moves on rounding
noise: ROADMAP, "Behaviours of the reference"), from the JAX ``fit``'s
initial weights. Each loss curve is held to ``gnn_tpu.train.fit``'s at rtol
1e-4 (in tier 1 its single-device run, which ``tests/test_parallel.py`` holds
to its run over a mesh at the same tolerance; the ``slow`` test holds it to
``dist.num_parts=4`` over the 8-device mesh itself, whose compiles take ~45 s
a model), and the curve and the accuracies to the port's one-process 4-part
``fit`` at rtol 1e-6 / atol 1e-6 (float32 sums split over two processes).
The ``slow`` test trains the GAT under SGD: under Adam the JAX 4-part GAT's
own curve ends 9.9e-5 (relative) from its single-device one, which the
port's follows to 2.6e-6, so port and JAX 4-part lie 1.25e-4 apart at epoch
6; under SGD all three agree to 1e-7 (Adam scales rounding-sized gradient
differences up to steps of ``lr``).
The data-parallel sampled ``sage`` (4 parts of 8 seeds) is held to the
port's one-process run only: its neighbour draws come from
``torch.Generator``, the JAX one's from ``jax.random``. Every run's final
parameters and buffers are equal on the two processes bit for bit, and a run
stopped at a checkpoint and resumed in the group (dropout on, so every
process's random streams count) equals an uninterrupted one bit for bit.
"""

import time

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_group_fit_worker as worker
from gnn_tpu import nn as jnn
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.train import Config as JaxConfig
from gnn_tpu.train import fit as jax_fit
from gnn_tpu.train.loop import build_model as jax_build_model
from gnn_tpu_torch.train import Config, fit

NODES, SEED = 120, 31


def _cfg(name: str, **over) -> dict:
    cfg = {
        "model": {"name": name, "hidden": 8, "heads": 2, "dropout": 0.0},
        "optim": {"name": "sgd" if name == "encoder_gcn" else "adam", "lr": 0.01},
        "train": {"epochs": 6, "eval_every": 2},
        "dist": {"num_parts": 4},
    }
    for key, value in over.items():
        section, field = key.split(".")
        cfg[section][field] = value
    return cfg


def _dp_cfg(**over) -> dict:
    return _cfg("sage", **{"model.hidden": 16, "train.batch_size": 32, "train.fanouts": [4, 3], **over})


def _one_process(case: dict) -> list:
    data = worker.data_of(case)
    cfg = Config.from_dict(case["cfg"])
    _, _, history = fit(cfg, data, model=worker.model_of(cfg, data, case["params"]), device="cpu", verbose=False)
    return history


def _full_graph_case(cfg: dict, jax_parts: int) -> dict:
    """A full-graph case with the JAX ``fit``'s initial weights and its loss
    curve (on ``jax_parts`` parts of the 8-device mesh, or on one device for
    0), without the port's one-process curve."""
    jcfg = JaxConfig.from_json(Config.from_dict(cfg).to_json())
    jcfg.dist.num_parts = jax_parts
    jdata = jax_sbm(num_nodes=NODES, num_classes=3, seed=SEED)
    jmodel = jax_build_model(jcfg, int(jdata.x.shape[1]), 3, jax.random.split(jax.random.PRNGKey(0))[1])
    params = {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()}
    _, _, jhist = jax_fit(jcfg, jdata, model=jmodel, verbose=False)
    return dict(cfg=cfg, params=params, reference=[h["loss"] for h in jhist], nodes=NODES, seed=SEED)


def _cases(jax_parts: int, gat_optimizer: str = "adam") -> dict:
    """The full-graph cases (``_full_graph_case``) and the data-parallel
    sampled case, each with the port's one-process curve."""
    cases = {
        name: _full_graph_case(_cfg(name, **({"optim.name": gat_optimizer} if name == "gat" else {})), jax_parts)
        for name in ("gcn", "gat", "encoder_gcn")
    }
    cases["sage-dp-sampled"] = dict(cfg=_dp_cfg(), params=None, reference=None, nodes=300, seed=0)
    for case in cases.values():
        case["one_process"] = _one_process(case)
    return cases


def _spawn(fn, args: tuple) -> None:
    """Two processes of ``fn(rank, *args)``, 120 s at most."""
    ctx = mp.spawn(fn, args=args, nprocs=2, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two-process run took more than 120 s")


def _run_group(tmp_path, cases: dict, resume_cases: dict) -> None:
    _spawn(worker.run, (f"file://{tmp_path / 'store'}", cases, resume_cases, str(tmp_path)))


def test_fit_in_a_group_needs_a_part_a_process(tmp_path):
    """A group of two processes without ``dist.num_parts`` would have both
    train the whole graph as rank 0 and write the same log and checkpoints:
    ``fit`` refuses it on each process, naming ``--dist.num_parts``, before
    it writes anything (also with ``dist.num_parts=1``); the same run with
    ``dist.num_parts=2`` trains (``tests/torch_group_fit_worker.py::refusal``)."""
    _spawn(worker.refusal, (f"file://{tmp_path / 'store'}", str(tmp_path)))


def test_fit_in_a_two_process_group_matches_one_process_and_jax(tmp_path):
    resume_cases = {
        "encoder_gcn-dropout": dict(cfg=_cfg("encoder_gcn", **{"model.dropout": 0.3}), nodes=NODES, seed=SEED),
        "sage-dp-sampled-dropout": dict(cfg=_dp_cfg(**{"model.dropout": 0.5}), nodes=300, seed=0),
    }
    _run_group(tmp_path, _cases(jax_parts=0), resume_cases)


@pytest.mark.slow
def test_fit_in_a_two_process_group_matches_jax_over_four_parts(tmp_path):
    _run_group(tmp_path, _cases(jax_parts=4, gat_optimizer="sgd"), {})
