"""A configuration, a cell and a per-layer metric dropped in as new files
and entries are found by name, without an edit of a file already there."""

from __future__ import annotations

import json

from gnnbench import bench


def test_new_files_are_found(tiny_root, capsys):
    g = tiny_root / "gnnbench"
    cfg = json.loads((g / "configs" / "gcn-arxiv.json").read_text())
    cfg.update(name="gcn-narrow", model={**cfg["model"], "hidden": 64, "num_layers": 2})
    (g / "configs" / "gcn-narrow.json").write_text(json.dumps(cfg))
    cell = json.loads((g / "workloads" / "gcn-arxiv.full.json").read_text())
    cell.update(config="gcn-narrow", why="a throwaway cell")
    (g / "workloads" / "gcn-narrow.full.json").write_text(json.dumps(cell))
    (g / "metrics" / "hidden_width.py").write_text("def read(t):\n    return t.spec.config['model']['hidden']\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "gcn-narrow", "source": cfg["source"], "file": "gnnbench/configs/gcn-narrow.json",
                            "reduced": [], "why": "a throwaway configuration"})
    spec["workloads"].append({"name": "gcn-narrow.full", "config": "gcn-narrow", "traffic": "full", "chips": 1,
                              "why": "a throwaway cell"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "gcn-arxiv.full" in m["workloads"]:
            m["workloads"].append("gcn-narrow.full")
    spec["per_layer"].append({"name": "hidden_width", "unit": "features", "better": "higher", "source": "program_counter",
                              "layer": "train step", "moves": "step_ms", "workloads": ["gcn-narrow.full"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench.run(["--workload", "gcn-narrow.full", "--seed", "5", "--seconds", "0.2", "--trace", "1"], 0.0, tiny_root,
              device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["hidden_width"] == {"value": 64.0, "unit": "features"}
    bench.run(["--workload", "gcn-narrow.full", "--seed", "6", "--seconds", "0.2", "--trace", "0"], 0.0, tiny_root,
              device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"step_ms", "step_p95_ms", "peak_mem_gib", "setup_s"}
