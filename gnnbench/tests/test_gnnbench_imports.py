"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's); the
reference imports nothing of the port."""

from __future__ import annotations

import ast

from gnnbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gnn_tpu"}


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted((ROOT / "gnnbench").rglob("*.py"))
    assert files
    for path in files:
        assert not imported(path) & FORBIDDEN, path


def test_reference_is_plain():
    for path in sorted((ROOT / "gnnbench" / "reference").glob("*.py")):
        assert imported(path) <= {"__future__", "contextlib", "dataclasses", "typing", "torch", "gnnbench"}, path


def test_a_run_loads_no_jax(tiny_root, capsys):
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r); from gnnbench import bench; "
        "bench.run(['--workload', 'gcn-arxiv.full', '--seed', '2', '--seconds', '0.1', '--trace', '0'], 0.0, "
        "__import__('pathlib').Path(%r), device='cpu'); print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
        % (str(ROOT), str(tiny_root), FORBIDDEN)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
