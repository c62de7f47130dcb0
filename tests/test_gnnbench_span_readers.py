"""The benchmark's readers of the port's spans (``agg_ms``, ``dropout_ms``,
``optim_ms``, ``optim_host_ms``) on a synthetic trace: device operations
inside nested ranges, one inside two ranges counted once, one that crosses
a range's end left out, and None where the trace holds no such range."""

from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gnnbench import bench

ROOT = Path(__file__).resolve().parents[1]

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
STEPS = 2


@dataclass
class Event:
    name: str
    start: float
    end: float
    device_type: object = CUDA
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return SimpleNamespace(start=self.start, end=self.end)


def span(name, start, end):
    """A span as the profiler gives it: the host's range and its copy on the
    device."""
    return [Event(name, start, end, CPU, True), Event(name, start, end, CUDA, True)]


def traced(events) -> bench.Traced:
    kernels = [e for e in events if e.device_type == CUDA and not e.is_user_annotation]
    return bench.Traced(spec=None, shapes={}, steps=STEPS, window_s=1.0, events=events, kernels=kernels, busy_s=0.0,
                        counters={})


def read(metric, events):
    spec = bench.load_spec(ROOT, "gat-arxiv.sampled" if metric.endswith(".sampled") else "gat-arxiv.full")
    return bench.reader(spec, metric).read(traced(events))


def kernel(start, end, name="k"):
    return Event(name, start, end)


# agg.spmm_heads.bwd [0, 100] holds agg.edge_aggregate [10, 40]; the SDDMM's
# span [200, 300] is read with them; one operation lies inside both nested
# ranges, one crosses the outer range's end, one lies outside every range.
AGG = (span("agg.spmm_heads.bwd", 0, 100) + span("agg.edge_aggregate", 10, 40) + span("spmm_heads.dw", 200, 300)
       + [kernel(20, 30), kernel(50, 60), kernel(90, 110), kernel(210, 250), kernel(400, 420)])


@pytest.mark.parametrize("metric", ["agg_ms", "agg_ms.sampled"])
def test_agg_ms_counts_each_operation_once(metric):
    assert read(metric, AGG) == pytest.approx((10 + 10 + 40) / 1e3 / STEPS)


def test_agg_ms_needs_an_agg_span():
    """The SDDMM's span alone (a program without the agg spans) reads
    nothing: it is sddmm_ms's."""
    assert read("agg_ms", span("spmm_heads.dw", 200, 300) + [kernel(210, 250)]) is None


def test_dropout_ms():
    events = span("dropout", 0, 50) + span("dropout", 100, 130) + [kernel(5, 45), kernel(100, 130), kernel(60, 90)]
    assert read("dropout_ms", events) == pytest.approx((40 + 30) / 1e3 / STEPS)


def test_optim_ms():
    events = span("Optimizer.step#Adam.step", 0, 200) + span("optim.step", 5, 190) + span("optim.zero_grad", 300, 310)
    events += [kernel(10, 20), kernel(30, 35), kernel(195, 198)]
    assert read("optim_ms", events) == pytest.approx((10 + 5) / 1e3 / STEPS)


def test_optim_host_ms_is_the_union_of_its_ranges():
    events = span("optim.step", 0, 100) + span("optim.step", 150, 170) + span("optim.zero_grad", 90, 120)
    assert read("optim_host_ms", events) == pytest.approx((120 + 20) / 1e3 / STEPS)


@pytest.mark.parametrize("metric", ["agg_ms", "agg_ms.sampled", "dropout_ms", "optim_ms", "optim_host_ms"])
def test_none_without_the_spans(metric):
    assert read(metric, [kernel(0, 10), Event("aten::mul", 0, 10, CPU)]) is None
    cpu_only = [e for e in AGG + span("dropout", 0, 5) if e.device_type == CPU]  # a trace of the CPU alone
    if metric != "optim_host_ms":
        assert read(metric, cpu_only) is None
