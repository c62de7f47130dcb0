"""The benchmark's own CPU tests (``gnnbench/tests/``), one case a file.

Each file runs in a fresh process from the root of the repository: a run of
the benchmark refuses a process in which JAX is loaded
(``gnnbench/bench.py::forbidden_modules``), and this suite's processes load
it through the JAX package's tests.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.name for p in (ROOT / "gnnbench" / "tests").glob("test_*.py"))


def test_the_suite_has_files():
    assert len(FILES) >= 5


@pytest.mark.parametrize("name", FILES)
def test_gnnbench_file(name):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", f"gnnbench/tests/{name}", "-q", "-p", "no:cacheprovider"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
