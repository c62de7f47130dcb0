"""The cell ``gatv2-arxiv.full``: a run on the CPU at the tiny size is
``correct``; the same run with GAT's static score planted in GATv2's place
is not, so the comparison tells the two attention mechanisms apart; and the
cell's two readers (``gatv2_score_ms``, ``gatv2_score_roofline``) on a
synthetic trace."""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import pytest
import torch

from gnnbench import bench, bounds
from gnnbench.tests.conftest import ROOT

CELL = "gatv2-arxiv.full"
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def run_line(root, capsys, trace=0, seed=2**31 + 5):
    bench.run(["--workload", CELL, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace)], 0.0, root,
              device="cpu")
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_is_correct_on_the_cpu(tiny_root, capsys, trace):
    line = run_line(tiny_root, capsys, trace)
    assert line["correct"] is True, line["checks"]
    if not trace:
        assert set(line["metrics"]) == {"step_ms", "step_p95_ms", "peak_mem_gib", "setup_s"}


def test_gat_static_score_planted_is_not_correct(tiny_root, capsys, monkeypatch):
    """GATv1's score LeakyReLU(a . h_dst[i] + a . h_src[j]) in place of
    GATv2's a . LeakyReLU(h_dst[i] + h_src[j]), on the same parameters."""
    import gnn_tpu_torch.mp.gatv2 as gatv2

    def static_score(adj, h_src, h_dst, att, negative_slope=0.2):
        a_src, a_dst = (h_src * att).sum(-1), (h_dst * att).sum(-1)
        return torch.nn.functional.leaky_relu(a_dst[adj.dst.long()] + a_src[adj.src.long()], negative_slope)

    monkeypatch.setattr(gatv2, "gatv2_score_edges", static_score)
    line = run_line(tiny_root, capsys)
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > 10 * line["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("scale", [2.0, 0.0])
def test_att_gradient_fault_is_not_correct(tiny_root, capsys, monkeypatch, scale):
    """The score's backward with only ``datt`` wrong (doubled, or dropped),
    the part of its output that comes from the kernel's two-stage reduction:
    the worst leaf's first gradient, ``grad_gap``, reads it."""
    op = importlib.import_module("gnn_tpu_torch.ops.cuda.gatv2_score")  # the package's name is the function's
    bwd = op.gatv2_score_bwd

    def faulty(*args, **kwargs):
        dh_src, dh_dst, datt = bwd(*args, **kwargs)
        return dh_src, dh_dst, scale * datt

    monkeypatch.setattr(op, "gatv2_score_bwd", faulty)
    line = run_line(tiny_root, capsys)
    assert line["correct"] is False
    cell_limit = json.loads((ROOT / "gnnbench" / "workloads" / f"{CELL}.json").read_text())["limits"]["grad_gap"]
    assert line["checks"]["grad_gap"]["value"] > 10 * max(line["checks"]["grad_gap"]["limit"], cell_limit)


class Event(SimpleNamespace):
    @property
    def time_range(self):
        return SimpleNamespace(start=self.start, end=self.end)


def span(name, start, end):
    return [Event(name=name, start=start, end=end, device_type=d, is_user_annotation=True) for d in (CPU, CUDA)]


def kernel(name, start, end):
    return Event(name=name, start=start, end=end, device_type=CUDA, is_user_annotation=False)


def traced(events, counters, steps=2):
    spec = bench.load_spec(ROOT, CELL)
    spec.cell_edges = spec.dataset["num_edges"] * 2
    kernels = [e for e in events if e.device_type == CUDA and not e.is_user_annotation]
    return bench.Traced(spec=spec, shapes=spec.shapes(), steps=steps, window_s=1.0, events=events, kernels=kernels,
                        busy_s=0.0, counters=counters)


# a step's forward and backward spans, each holding its kernels; a GEMM
# outside them; two steps
EVENTS = (span("agg.gatv2_score", 0, 100) + span("agg.gatv2_score.bwd", 200, 400)
          + [kernel("void gnn::gatv2_score_kernel<true, 2>(int const*)", 10, 60),
             kernel("void gnn::gatv2_score_bwd_kernel<true, 16, gnn::gatv2_score_by_dst>()", 210, 300),
             kernel("void gnn::csr_reduce_fixup<float, true, gnn::gatv2_score_by_dst>()", 300, 310),
             kernel("void gnn::gatv2_score_datt_kernel(float const*)", 390, 400),
             kernel("sm80_xmma_gemm_f32f32", 500, 600)])


def read(metric, events=EVENTS, counters=None):
    counters = {"gatv2_score": 2.0, "gatv2_score_bwd": 2.0} if counters is None else counters
    return bench.reader(bench.load_spec(ROOT, CELL), metric).read(traced(events, counters))


def test_gatv2_score_ms_reads_its_spans():
    assert read("gatv2_score_ms") == pytest.approx((50 + 90 + 10 + 10) / 1e3 / 2)
    assert read("gatv2_score_ms", [kernel("k", 0, 10)]) is None


def test_gatv2_score_roofline_reads_its_kernels_and_counters():
    spec = bench.load_spec(ROOT, CELL)
    spec.cell_edges = spec.dataset["num_edges"] * 2
    bounds = spec.module("flops", "gatv2").kernel_bounds(spec.config, spec.shapes())["gatv2_score"]
    assert len(bounds) == 4  # forward and backward of each layer
    ms = (50 + 90 + 10 + 10) / 1e3 / 2
    assert read("gatv2_score_roofline") == pytest.approx(100 * sum(b.bound_s for b in bounds) * 1e3 / ms)
    assert read("gatv2_score_roofline", counters={"gatv2_score": 2.0, "gatv2_score_bwd": 1.0}) is None
    assert read("gatv2_score_roofline", [kernel("sm80_xmma_gemm_f32f32", 0, 10)]) is None


def test_flops_and_bounds_by_hand():
    """On the tiny graph of test_gnnbench_flops.py (5 nodes, 7 edges with the
    self loops, 3 features, 2 classes) at 2 heads x 4."""
    flops = bench.load_module(ROOT / "gnnbench" / "flops" / "gatv2.py")
    config, shapes = {"model": {"hidden": 4, "heads": 2, "num_layers": 2}}, {"nodes": 5, "edges": 7, "features": 3,
                                                                             "classes": 2}
    # layer 1: 3 -> 2 heads x 4, two projections forward and dW 2 * (2 * 2*5*3*8) = 960, the score (4 + 8) * 7*8
    # = 672, K3 and the SDDMM 3 * 2*7*8 = 336; layer 2: 8 -> 1 x 2, projections 2 * (3 * 2*5*8*2) = 960, the
    # score 12 * 7*2 = 168, K3 and the SDDMM 3 * 2*7*2 = 84
    assert flops.step_flops(config, shapes) == 960 + 672 + 336 + 960 + 168 + 84
    b = flops.kernel_bounds(config, shapes)
    assert len(b["K3"]) == 4 and len(b["gatv2_score"]) == 4
    # forward of layer 1: h_src, h_dst 2 * 5*8*4, att 8*4, src and dst 2 * 7*4, s 7*2*4 bytes; 4 * 7*8 operations
    assert b["gatv2_score"][0] == bounds.Bound(bytes=320 + 32 + 56 + 56, operations=224)
    # backward: ds 56, h_src, h_dst, att 352, src and dst 2 * 7*4; out 352
    assert b["gatv2_score"][1] == bounds.Bound(bytes=56 + 352 + 56 + 352, operations=448)
