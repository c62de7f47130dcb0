"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
whose configurations are shrunk to a few hundred nodes, so that a run of a
cell can be driven on the CPU (its look for a card skipped)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
TINY_DATASET = {"num_nodes": 300, "num_edges": 1200}
TINY_TRAFFIC = {"batch_size": 16, "fanouts": [4, 3]}
# The comparison's limits at this size on the CPU, between the program's
# readings and the TF32 control's on five seeds of each cell.
TINY_LIMITS = {"logit_gap": 3e-5, "first_loss_gap": 1e-6, "loss_gap": 1e-4, "grad_gap": 3e-6, "grad_total_gap": 1e-5,
               "change_gap": 3e-4, "change_total_gap": 1e-4}


def shrink(root: Path) -> None:
    """Cut every configuration's graph and every sampled cell's batch to a
    CPU test's size; widths and everything else stay."""
    for path in (root / "gnnbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["dataset"].update(TINY_DATASET)
        path.write_text(json.dumps(cfg))
    for path in (root / "gnnbench" / "workloads").glob("*.json"):
        cell = json.loads(path.read_text())
        if cell["traffic"]["mode"] == "sampled":
            cell["traffic"].update(TINY_TRAFFIC)
        cell["trace_steps"], cell["warmup_steps"] = 2, 1
        cell["limits"] = {k: TINY_LIMITS[k] for k in cell["limits"] if k in TINY_LIMITS} | {"dropout_keep_sigma": 6}
        path.write_text(json.dumps(cell))


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and gnnbench/ with shrunk configurations."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gnnbench", tmp_path / "gnnbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    torch.set_num_threads(2)
    return tmp_path


@pytest.fixture
def cuda_device():
    """The card, for the tests marked ``gpu``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
