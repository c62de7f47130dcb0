"""BENCHMARK.json, the configuration, cell and metric files, and a run's
last line, held to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from gnnbench import bench
from gnnbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["gnnbench"] and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check (2 + 14 runs a cell, 24 cells) fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["name"] in used and c["file"].startswith("gnnbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / "gnnbench" / "reference" / f"{cfg['model']['name']}.py").is_file()
        assert (ROOT / "gnnbench" / "flops" / f"{cfg['flops']}.py").is_file()
        assert cfg["dtype"] == "float32" and cfg["peak_flops"] > 0


def test_workloads():
    pairs, names = set(), set()
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs and w["name"] not in names
        pairs.add((w["config"], w["traffic"]))
        names.add(w["name"])
        cell = json.loads((ROOT / "gnnbench" / "workloads" / f"{w['name']}.json").read_text())
        assert set(cell) == {"config", "traffic", "warmup_steps", "trace_steps", "limits", "why"}
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert cell["traffic"]["mode"] in ("full", "sampled")
        assert cell["traffic"]["graph"]["recipe"] in ("power_law", "clustered_power_law")
        assert {"logit_gap", "change_gap", "change_total_gap", "dropout_keep_sigma"} <= set(cell["limits"])
        assert {"first_loss_gap", "loss_gap"} & set(cell["limits"]) and {"grad_gap", "grad_total_gap"} & set(cell["limits"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    seen = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert bench.reader(bench.load_spec(ROOT, next(iter(m.get("workloads", cells)))), m["name"]).read
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    assert all(len(spellings) == 1 for spellings in layers.values())
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny_root, capsys, trace):
    bench.run(["--workload", "gcn-arxiv.full", "--seed", str(2**31 + 11), "--seconds", "0.3", "--trace", str(trace)],
              0.0, tiny_root, device="cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert ("breakdown" in line) == bool(trace)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if not trace:
        assert set(line["metrics"]) == {"step_ms", "step_p95_ms", "peak_mem_gib", "setup_s"}
        assert all(m["value"] > 0 for name, m in line["metrics"].items() if name != "peak_mem_gib")
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    # the numbers compared, each beside its limit, are the last lines on standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_refused_without_a_card(tiny_root, monkeypatch, capsys):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", "gcn-arxiv.full", "--seed", "1", "--seconds", "1", "--trace", "0"], 0.0, tiny_root)
    assert rc != 0 and capsys.readouterr().out == ""
