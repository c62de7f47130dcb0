"""The port's spans and its hook for what a step draws
(``gnn_tpu_torch/utils/tracing.py``), and ``TrainStep.step``.

The spans are counted in one training step under ``torch.profiler`` on the
CPU, each count stated from the model's structure; the hook is held to what
the benchmark's ``Capture`` reads by patching the same functions.
"""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from gnn_tpu_torch.graphs import stochastic_block_model
from gnn_tpu_torch.train import Config
from gnn_tpu_torch.train.loop import build_model, build_optimizer, build_step
from gnn_tpu_torch.utils import tracing
from gnn_tpu_torch.utils.tracing import emit, span, watch

SPAN_PREFIXES = ("agg.", "dropout", "optim.", "sampled.", "spmm_heads.", "blocked_matvec.", "halo.")


def _program(model: str, num_layers: int, seed: int = 1, **train):
    data = stochastic_block_model(120, 3, seed=0)
    cfg = Config.from_dict({
        "model": {"name": model, "hidden": 8, "num_layers": num_layers, "heads": 2, "dropout": 0.5},
        "optim": {"weight_decay": 5e-4},
        "train": {"seed": seed, **train},
    })
    net = build_model(cfg, data.num_features, int(data.y.max()) + 1, torch.Generator().manual_seed(seed))
    step = build_step(cfg, data, net, torch.device("cpu"))
    params = list(net.parameters())
    return step, build_optimizer(cfg, params), params


def _gat_spans(layers: int, input_dropout: bool) -> dict:
    """A GAT step's spans: per layer the edge score (both node scores
    gathered, added and through LeakyReLU in one op), the softmax (shift,
    exp and denominator in one op) and K3 forward; K3's backward with its
    SDDMM, the softmax's backward and the score's backward (its kernel, K2
    and K1, each inside that span and no other); the attention dropout, and
    the input dropout on the full graph."""
    return {
        "agg.gat_score": layers, "agg.edge_softmax": layers,
        "agg.spmm_heads": layers, "agg.spmm_heads.bwd": layers, "spmm_heads.dw": layers, "agg.edge_softmax.bwd": layers,
        "agg.gat_score.bwd": layers,
        "dropout": 2 * layers if input_dropout else layers,
        "optim.step": 1, "optim.zero_grad": 1,
    }


CASES = {
    # a dropout, K1 forward and K1's transpose in each of 3 layers
    "gcn": (("gcn", 3), {}, {"agg.spmm": 3, "agg.spmm.bwd": 3, "dropout": 3, "optim.step": 1, "optim.zero_grad": 1}),
    # the community order: K1 over its CSR as on any other order, no span of a block product
    "gcn-blocked": (("gcn", 3), {"reorder": "cluster"}, {"agg.spmm": 3, "agg.spmm.bwd": 3,
                                                          "dropout": 3, "optim.step": 1, "optim.zero_grad": 1}),
    "gat": (("gat", 2), {}, _gat_spans(2, input_dropout=True)),
    "gat-sampled": (("gat", 2), {"batch_size": 8, "fanouts": [3, 2]},
                    {**_gat_spans(2, input_dropout=False), "sampled.sample": 1, "sampled.gather": 1}),
}


def _spans(events) -> collections.Counter:
    return collections.Counter(e.name for e in events if e.name.startswith(SPAN_PREFIXES))


@pytest.mark.parametrize("case", list(CASES))
def test_spans_in_one_step(case):
    (model, layers), train, expected = CASES[case]
    step, opt, params = _program(model, layers, **train)
    step.step(opt, params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step.step(opt, params)
    events = list(prof.events())
    assert dict(_spans(events)) == expected
    inner = [e for e in events if e.name == "spmm_heads.dw"]
    outer = [e for e in events if e.name == "agg.spmm_heads.bwd"]
    for e in inner:  # the SDDMM's span stays inside K3's backward
        assert sum(o.time_range.start <= e.time_range.start and e.time_range.end <= o.time_range.end
                   for o in outer) == 1


def test_spans_only_in_the_active_steps():
    """Under the benchmark's schedule (one warm-up step, then the active
    ones) a span is recorded in the active steps alone."""
    step, opt, params = _program("gcn", 3)
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            step.step(opt, params)
            prof.step()
    assert dict(_spans(prof.events())) == CASES["gcn"][2]


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    monkeypatch.setattr(tracing, "record_function", lambda name: pytest.fail("record_function without a profiler"))
    a, b = span("agg.spmm"), span("dropout")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass


@pytest.mark.parametrize("legacy", [False, True])
def test_span_under_a_profiler_is_a_range(legacy):
    recorder = torch.autograd.profiler.profile() if legacy else profile(activities=[ProfilerActivity.CPU])
    with recorder as prof:
        with span("agg.spmm"):
            torch.ones(3).sum()
    events = prof.function_events if legacy else prof.events()
    assert [e.name for e in events if e.name == "agg.spmm"] == ["agg.spmm"]


def test_emit_without_a_watcher_returns_at_once():
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError("the payload was read")

    assert emit("dropout", x=Untouchable()) is None


def test_watch_registers_for_its_block_only():
    seen = []
    with pytest.raises(RuntimeError), watch(lambda kind, **p: seen.append((kind, p))):
        emit("sample", nodes=1)
        raise RuntimeError
    emit("sample", nodes=2)
    assert seen == [("sample", {"nodes": 1})] and not tracing._watchers


@pytest.mark.parametrize("train", [{}, {"batch_size": 8, "fanouts": [3, 2]}], ids=["full", "sampled"])
def test_watch_sees_what_the_benchmark_captures(train):
    """Two seeded steps of a tiny GAT under the hook and under the
    benchmark's patching: the same keep masks (as far as the output shows
    them: a dropped 0 reads as kept), logits and node ids."""
    from gnnbench.bench import Capture

    step, opt, params = _program("gat", 2, seed=7, **train)
    seen = collections.defaultdict(list)
    with Capture() as cap, watch(lambda kind, **p: seen[kind].append(p)):
        for _ in range(2):
            step.step(opt, params)
        masks, _, nodes, logits = cap.take()
    assert len(seen["dropout"]) == len(masks) == (4 if not train else 2) * 2
    for p, m in zip(seen["dropout"], masks):
        assert p["rate"] == 0.5 and torch.equal(p["mask"] | (p["x"] == 0), m)
        assert torch.equal(p["out"], torch.where(p["mask"], p["x"] / 0.5, torch.zeros_like(p["x"])))
    assert len(seen["cross_entropy"]) == len(logits) == 2
    assert all(torch.equal(p["logits"].detach(), c) for p, c in zip(seen["cross_entropy"], logits))
    assert len(seen["sample"]) == len(nodes) == (2 if train else 0)
    assert all(torch.equal(p["nodes"], n) for p, n in zip(seen["sample"], nodes))


@pytest.mark.parametrize("model,train,clip", [("gcn", {}, 0.0), ("gat", {}, 1.0),
                                              ("gat", {"batch_size": 8, "fanouts": [3, 2]}, 0.5)])
def test_train_step_is_fits_step(model, train, clip):
    """``TrainStep.step`` takes the steps of the sequence ``fit`` ran
    before it, bit for bit."""
    from gnn_tpu_torch.optim import clip_by_global_norm

    a, opt_a, params_a = _program(model, 2, **train)
    b, opt_b, params_b = _program(model, 2, **train)
    for _ in range(3):
        loss_a = a.step(opt_a, params_a, clip)
        opt_b.zero_grad(set_to_none=True)
        loss_b = b.loss()
        loss_b.backward()
        if clip > 0:
            clip_by_global_norm(params_b, clip)
        opt_b.step()
        assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(p, q) for p, q in zip(params_a, params_b))
