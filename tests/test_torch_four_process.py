"""Four processes of a gloo group on the CPU, one mesh position each: the
layouts that only four cards use (one part a process, L = 1; a (2, 2)
mesh whose model groups and data groups both span processes), in one spawn
(``tests/torch_four_process_worker.py``, a ``file://`` store in a temporary
directory, one torch thread a process, 120 s at most).

* ``fit`` with ``dist.num_parts=4``: the GCN (Adam) in each halo mode, the
  GAT and EncoderGCN under SGD on the graphs of
  ``tests/test_torch_group_fit.py``, from the JAX ``fit``'s initial weights,
  and the data-parallel sampled GraphSAGE; each loss curve and the
  accuracies against the port's one-process 4-part ``fit`` at rtol 1e-6 /
  atol 1e-6, the curves of the full-graph models against
  ``gnn_tpu.train.fit`` on one device at rtol 1e-4, the final parameters and
  buffers bit for bit on the four processes. The GAT trains under SGD
  there and again under Adam, the port's default, held at rtol 1e-4 to both
  curves: under Adam its first loss is equal, and the curve over four
  processes then drifts from the one-process one by rounding (5.0e-5
  relative at epoch 6; under SGD within 1e-6), as Adam scales gradients
  summed in another order up to steps of ``lr``, the drift that ROADMAP
  records for the JAX 4-part GAT too;
* the tensor-parallel GCN of ``tests/test_torch_tensor_parallel.py`` on a
  (2, 2) mesh: the subgroups' layout, the loss within 1e-5 of the JAX one and
  every gradient within rtol 2e-4 / atol 1e-5;
* ``dryrun_multichip(4, device="cpu")`` in the group: every loss finite.
"""

import json
import time

import pytest
import torch.multiprocessing as mp

import torch_four_process_worker as worker
from test_torch_group_fit import _cases, _cfg, _dp_cfg, _full_graph_case, _one_process
from test_torch_tensor_parallel import jax_tp  # noqa: F401  (fixture)

FIT_CASES = ("gcn-alltoall", "gcn-allgather", "gcn-overlap", "gat", "gat-adam", "encoder_gcn", "sage-dp-sampled")


@pytest.fixture(scope="module")
def four_processes(jax_tp, tmp_path_factory):  # noqa: F811
    """Runs the four processes once; what each found, by rank."""
    cases = _cases(jax_parts=0, gat_optimizer="sgd")
    for halo in ("allgather", "overlap"):
        case = dict(cases["gcn"], cfg=_cfg("gcn", **{"dist.halo": halo}))
        case["one_process"] = _one_process(case)
        cases[f"gcn-{halo}"] = case
    cases["gcn-alltoall"] = cases.pop("gcn")
    # the GAT under Adam, the port's default, at the tolerance of the JAX comparison
    cases["gat-adam"] = dict(_full_graph_case(_cfg("gat"), jax_parts=0), rtol=1e-4)
    cases["gat-adam"]["one_process"] = _one_process(cases["gat-adam"])
    assert sorted(cases) == sorted(FIT_CASES) and cases["sage-dp-sampled"]["cfg"] == _dp_cfg()
    graph, weights, loss, grads = jax_tp
    tp = dict(graph=graph, weights=weights, loss=loss, grads=grads)
    directory = tmp_path_factory.mktemp("four_processes")
    ctx = mp.spawn(worker.run, args=(f"file://{directory / 'store'}", cases, tp, str(directory)), nprocs=worker.WORLD,
                   join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the four-process run took more than 120 s")
    found = [json.loads((directory / f"rank{r}.json").read_text()) for r in range(worker.WORLD)]
    assert not any(f["jax imported"] for f in found)
    return found


def _held(found: list, check: str) -> None:
    failures = {rank: f[check] for rank, f in enumerate(found) if f[check] != "ok"}
    assert not failures, "\n".join(f"rank {rank}:\n{text}" for rank, text in failures.items())


@pytest.mark.parametrize("case", FIT_CASES)
def test_fit_on_four_processes_one_part_each_matches_one_process(four_processes, case):
    _held(four_processes, f"fit {case}")


def test_tensor_parallel_gcn_on_a_two_by_two_mesh_of_four_processes_matches_jax(four_processes):
    _held(four_processes, "tensor parallel")


def test_dryrun_multichip_runs_one_position_a_process(four_processes):
    _held(four_processes, "dryrun_multichip")
