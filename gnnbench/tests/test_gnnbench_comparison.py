"""The comparison that decides ``correct``: the plain reference against the
port's CPU path at a tiny size, the TF32 control, and the run with the timed
path broken underneath."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gnnbench import bench, calibrate, graphs
from gnnbench.tests.conftest import TINY_LIMITS

CELLS = ["gcn-arxiv.full", "gat-arxiv.full", "gat-arxiv.sampled", "gcn-arxiv.clustered"]


def spec_and_edges(root, cell):
    spec = bench.load_spec(root, cell)
    edges = graphs.edges(spec.dataset, spec.traffic["graph"])
    spec.cell_edges = edges.shape[1]
    return spec, edges


@pytest.mark.parametrize("cell", CELLS)
def test_reference_against_the_port(tiny_root, cell):
    """The port's first steps on the CPU, held to the float64 reference,
    and the TF32 control read ten times as far off at least."""
    spec, edges = spec_and_edges(tiny_root, cell)
    r = calibrate.readings(spec, 7, edges, torch.device("cpu"))
    assert all(v == 0 for k, v in r["judged"].items() if k != "dropout_keep_sigma")
    assert r["judged"]["dropout_keep_sigma"] < 6
    for name, limit in TINY_LIMITS.items():
        assert r["program"][name] < limit / 3, name
    assert r["control"]["logit_gap"] > 3 * TINY_LIMITS["logit_gap"]
    assert r["half_batch"]["first_loss_gap"] > 30 * TINY_LIMITS["first_loss_gap"]
    assert r["altered_gradient"]["change_total_gap"] > 30 * TINY_LIMITS["change_total_gap"]
    assert r["altered_bias"]["change_gap"] > 10 * TINY_LIMITS["change_gap"]


@pytest.mark.gpu
def test_control_fails_on_the_card(tiny_root, cuda_device):
    """On the card, the control (TF32 products) fails a limit that the
    program meets."""
    for cell in ("gcn-arxiv.full", "gat-arxiv.sampled"):
        spec, edges = spec_and_edges(tiny_root, cell)
        r = calibrate.readings(spec, 3, edges, cuda_device)
        assert all(r["program"][k] <= v for k, v in TINY_LIMITS.items())
        assert any(r["control"][k] > v for k, v in TINY_LIMITS.items())


def run_line(root, cell, capsys, seed=3):
    bench.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace", "0"], 0.0, root, device="cpu")
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["gcn-arxiv.full", "gat-arxiv.sampled"])
def test_state_unchanged(tiny_root, capsys, monkeypatch, cell):
    from gnn_tpu_torch.optim import Adam

    monkeypatch.setattr(Adam, "step", lambda self, closure=None: None)
    line = run_line(tiny_root, cell, capsys)
    assert line["correct"] is False and line["checks"]["change_total_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["gcn-arxiv.full", "gat-arxiv.full", "gat-arxiv.sampled"])
def test_half_of_the_batch(tiny_root, capsys, monkeypatch, cell):
    import gnn_tpu_torch.train.loop as loop

    whole = loop.cross_entropy

    def half(logits, targets, mask=None, **kw):
        if mask is None:
            n = logits.shape[0] // 2
            return whole(logits[:n], targets[:n], **kw)
        ids = torch.nonzero(mask)[:, 0]
        mask = mask.clone()
        mask[ids[len(ids) // 2:]] = False
        return whole(logits, targets, mask, **kw)

    monkeypatch.setattr(loop, "cross_entropy", half)
    line = run_line(tiny_root, cell, capsys)
    assert line["correct"] is False and line["checks"]["loss_gap"]["value"] > TINY_LIMITS["loss_gap"]


@pytest.mark.parametrize("leaf, number", [("first weight", "change_total_gap"), ("last bias", "change_gap")])
def test_gradient_altered(tiny_root, capsys, monkeypatch, leaf, number):
    from gnn_tpu_torch.optim import Adam

    step = Adam.step

    def doubled(self, closure=None):  # at the first step
        params = self.param_groups[0]["params"]
        if leaf == "first weight":  # [hidden, 128 features]
            altered = next(p for p in params if p.dim() == 2 and p.shape[1] == 128)
        else:  # [classes]
            altered = [p for p in params if p.dim() == 1][-1]
        if not self.state.get(altered):
            altered.grad.mul_(2)
        return step(self, closure)

    monkeypatch.setattr(Adam, "step", doubled)
    line = run_line(tiny_root, "gcn-arxiv.full", capsys)
    assert line["correct"] is False and line["checks"][number]["value"] > TINY_LIMITS[number]


def test_neighbour_altered(tiny_root, capsys, monkeypatch):
    from gnn_tpu_torch.graphs.sampling import NeighborSampler

    spec, edges = spec_and_edges(tiny_root, "gat-arxiv.sampled")
    b = spec.traffic["batch_size"]
    sample = NeighborSampler.sample

    def altered(self, generator, seeds):
        nodes, adjs = sample(self, generator, seeds)
        seed = int(nodes[0])
        strangers = np.setdiff1d(np.arange(spec.dataset["num_nodes"]), edges[0][edges[1] == seed])
        nodes = nodes.clone()
        nodes[b] = int(strangers[strangers != seed][0])  # the seed's first draw, not a neighbour of it
        return nodes, adjs

    monkeypatch.setattr(NeighborSampler, "sample", altered)
    line = run_line(tiny_root, "gat-arxiv.sampled", capsys)
    assert line["correct"] is False and line["checks"]["neighbours_invalid"]["value"] >= 1
