"""``gnn_tpu_torch.utils`` and the entry check against gnn_tpu.

The seven checks: the same messages on the same inputs (numpy arrays; torch
tensors are accepted too). ``entry()`` on the CPU against
``__graft_entry__.entry()``'s forward, with the JAX parameters carried
across: rtol=1e-5, atol=1e-5 (float32 products and sums in another order).
"""

import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gnn_tpu import nn as jnn
from gnn_tpu.utils import checks as jchecks
from gnn_tpu.utils import profiling as jprofiling
from gnn_tpu_torch import entry as tentry
from gnn_tpu_torch import utils as tutils
from gnn_tpu_torch.nn import load_jax_state_dict
from gnn_tpu_torch.ops.cuda import bounds
from gnn_tpu_torch.utils import profiling as tprofiling

CASES = [
    ("normalize_dim", (3, 2)),
    ("normalize_dim", (-3, 2)),
    ("check_rank", (np.zeros((2, 3)), 3, "x")),
    ("check_dim", (np.zeros((2, 3)), -1, 4, "x")),
    ("check_dim", (np.zeros((2, 3)), 2, 4)),
    ("check_same_shape", (np.zeros((2, 3)), np.zeros((3, 2)), "in add")),
    ("check_broadcastable", (np.zeros((2, 3)), np.zeros((4, 3)))),
    ("check_matmul", (np.zeros(3), np.zeros((3, 2)))),
    ("check_matmul", (np.zeros((2, 3)), np.zeros((4, 2)))),
    ("check_matmul", (np.zeros((2, 2, 3)), np.zeros((3, 3, 4)))),
    ("check_edge_index", (np.zeros((3, 4), np.int64),)),
    ("check_edge_index", (np.zeros((2, 4), np.float32),)),
    ("check_edge_index", (np.zeros((2, 4), bool),)),
]


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_checks_raise_the_jax_messages(name, args):
    with pytest.raises(ValueError) as want:
        getattr(jchecks, name)(*args)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        getattr(tutils, name)(*args)


@pytest.mark.parametrize("name,args", [
    ("normalize_dim", (-1, 3)),
    ("check_rank", (np.zeros((2, 3)), 2)),
    ("check_dim", (np.zeros((2, 3)), 1, 3)),
    ("check_same_shape", (np.zeros(2), np.zeros(2))),
    ("check_broadcastable", (np.zeros((2, 1)), np.zeros((1, 5)))),
    ("check_matmul", (np.zeros((5, 2, 3)), np.zeros((3, 4)))),
    ("check_edge_index", (np.zeros((2, 4), np.int32),)),
])
def test_checks_pass_as_jax(name, args):
    assert getattr(jchecks, name)(*args) == getattr(tutils, name)(*args)


def test_checks_take_torch_tensors():
    tutils.check_edge_index(torch.zeros(2, 5, dtype=torch.int32))
    tutils.check_matmul(torch.zeros(2, 3), torch.zeros(3, 4))
    for bad in (torch.zeros(2, 5), torch.zeros(2, 5, dtype=torch.bool)):
        with pytest.raises(ValueError, match=f"integer-typed, got {bad.dtype}"):
            tutils.check_edge_index(bad)


def test_time_fn_trace_and_roofline_on_the_cpu(tmp_path):
    """time_fn times with the host clock where the result lies on the CPU;
    trace writes a Chrome trace; Roofline scores against the H100's figures
    (those of ops/cuda/bounds.py) with the JAX package's arithmetic."""
    calls = []
    secs = tprofiling.time_fn(lambda a: calls.append(1) or (a @ a,), torch.ones(64, 64), iters=4, warmup=2)
    assert secs > 0 and len(calls) == 6
    with tprofiling.trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    chip = tprofiling.H100
    assert (chip.hbm_gbps * 1e9, chip.f32_tflops * 1e12, chip.bf16_tflops * 1e12) == (
        bounds.H100_BYTES_PER_S, bounds.H100_F32_FLOPS, bounds.H100_BF16_FLOPS)
    jr = jprofiling.Roofline(chip=jprofiling.Chip("H100", chip.hbm_gbps, chip.bf16_tflops, chip.f32_tflops))
    tr = tprofiling.Roofline()
    for r, f32 in ((jr, np.float32), (tr, torch.float32)):
        r.add_read(((1024, 256), f32), ((1024,), np.int32)).add_write(((1024, 256), f32)).add_matmul(1024, 256, 256)
    assert (tr.bytes_accessed, tr.flops) == (jr.bytes_accessed, jr.flops)
    for dtype in ("bfloat16", "float32"):
        assert tr.compute_time_s(dtype) == jr.compute_time_s(dtype)
        assert tr.fraction_of_peak(1e-3, dtype) == jr.fraction_of_peak(1e-3, dtype)
    assert tr.memory_time_s == jr.memory_time_s


def test_entry_on_the_cpu_equals_graft_entry():
    """The flagship GCN forward: the same adjacency, features and
    (carried-across) parameters give the same logits. Its power-law edges
    are directed, so ``reorder='auto'`` keeps the ids in both packages."""
    jfn, (jmodel, jx, jadj) = graft.entry()
    fn, (model, x, adj) = tentry.entry(device="cpu")
    load_jax_state_dict(model, {k: np.asarray(v) for k, v in jnn.state_dict(jmodel).items()})
    assert adj.perm is None and jadj.perm is None and adj.layout == "ell"
    for name in ("src", "row_ptr", "t_perm", "weight"):
        np.testing.assert_array_equal(getattr(adj, name).numpy(), np.asarray(getattr(jadj, name)))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    with torch.no_grad():
        got = fn(model, x, adj)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jfn)(jmodel, jx, jadj)), rtol=1e-5, atol=1e-5)


def test_entry_needs_a_card_and_dryrun_waits_for_item_15(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.dryrun_multichip(8)
    # ported whole (the name is from before): its DistEdgeStream part and
    # its tensor-parallel half too (run on CPU parts in test_torch_dist_models)
    doc = tentry.dryrun_multichip.__doc__
    assert "item 15" not in doc and "DistEdgeStream" in doc and "(data, model) mesh" in doc
