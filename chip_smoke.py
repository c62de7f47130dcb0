"""Smoke run of the PyTorch / CUDA port (``gnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 builds the hand-written kernels from ``gnn_tpu_torch/csrc`` with
nvcc (one process per source, all at once) and the C++ graph core with g++,
and prints the card, its power limit and the build times; a register spill
that ptxas reports fails it. Phase 1 holds each
kernel against its plain PyTorch version on an ogbn-arxiv-scale graph (power
law, 169,343 nodes, about 2.5 M normalized edges with self loops), float32
and bfloat16, and times both with CUDA events: K1 and K2 at F in {40, 128,
256} (the GCN widths), then the GAT shapes: K3 forward and transpose at (H,
F) = (8, 32) and (1, 40), K2 at widths 8 and 1 (the softmax denominator), K1
over ``col = t_perm`` at width 8 (the VJP of the source gather), K1 with a
null weight at F in {128, 256} (GIN's plain neighbour sum); each
kernel call is also repeated and must give the same bits. Every row states
its bound from ``gnn_tpu_torch.ops.cuda.bounds`` (``bound_ms``: each input
and output byte once at 3.35 TB/s, or the operations at 67 TFLOP/s if that
is more; ``noreuse_ms``: a gathered row once per edge) and, in float32 where
one PyTorch call computes the same function, that call's time
(``library_ms``: ``torch.sparse.mm`` on a CSR tensor for K1 and for K3, whose
H heads become one [N H, N H] CSR of E H entries, ``torch.segment_reduce``
for K2; held to the kernel's result, used nowhere in the port). Phase
1-blocked builds the clustered arxiv-scale graph (``clustered_power_law``,
the recipe of bench.py's blocked workload) with ``reorder='cluster'`` twice,
at 256-row float32 and 512-row bfloat16 windows, and holds
``blocked_matvec`` (the block product plus K1 over the remainder CSR)
forward and transpose at F in {256, 40} against its plain version, the
float32 one also against K1 and ``torch.sparse.mm`` over the whole relabelled
CSR, with times of all; its ``bound_ms`` is that of the function (A @ x over
every edge), and ``layout_cost_ms`` beside it is what the dense blocks ask
for; two lines then set K1's F=256 time and K3's (8, 32) time on the two
graphs beside their edge counts and longest rows. Phase 1-hop holds the
kernels over the bipartite CSRs of neighbour-sampled hops (every row exactly
``fanout`` edges long, ``col`` contiguous; the transpose with one edge a row
behind a run of empty rows) of batch 1024, at every shape the sampled phases
launch them at: K1 with a null weight forward on each hop of fanouts [15,
10, 5] (F = 128, 256, 256) and of the host path's [10, 5] (F = 128, 256),
transposed on all but the outermost; K3 forward and transposed, K2 and K1
over ``col = t_perm`` on both hops of the GAT's [10, 5], at (8, 32) on the
outer and (1, 40) on the inner. Phase 1-relabel builds the power-law graph
again with ``reorder=True``, the degree-bucket node order that ``fit``'s
default ``train.reorder='auto'`` trains in, and holds K1 forward and dx at F
in {40, 128, 256} and with a null weight at F=128, K3 at (8, 32) and K2 at
[E, 8] over that CSR against their plain versions, a second call and the
library, each row printed beside the same call's row in id order; it also
scores one K1 call with ``utils.profiling`` (``time_fn``,
``Roofline(chip=H100)``). Phase 1-edge-agg holds ``ops.edge_agg`` there:
``edge_aggregate`` over the identity positions (one K2 launch) and over
``t_perm`` (one K1 launch) at [E, 8] and [E, 1], and ``edge_aggregate_max``
against ``segment_max``.
Phase 2 trains the port's full-graph GCN (3 layers, hidden 256, 40
classes) for 5 epochs on the power-law graph through
``gnn_tpu_torch.train.fit`` under the default order (relabelled), then
again with ``train.reorder`` 'false' (ids kept) and 'true', printing the
step time of each order; every full-graph phase prints whether ``fit``'s
adjacency carried a ``perm`` and checks it;
phase 2-gat trains the GAT (2 layers, 8 heads x 32, 1 output head over 40
classes) for 5 epochs there; phase 2-cluster trains the GCN on the clustered
graph twice with the same seeds, with ``train.reorder='cluster'`` (the
blocked layout) and ``'auto'`` (the CSR). Phases 2-encoder, 2-sage and 2-gin
train, 5 epochs each on the power-law graph, the reference's flagship
EncoderGCN (pre-MLP 128 -> 256 -> 128, two mid-block convs at 128, post-MLP
to 40 classes; Adam), GraphSAGE (3 x 256, mean; Adam) and GIN (3 x 256; SGD
with momentum and gradient clipping), all of whose aggregation is K1. Each
checks its losses and that it
launched its kernels as often as its layers ask. Phases 2-sampled-sage and
2-sampled-gat train on neighbour-sampled minibatches through the same
``fit`` (``train.batch_size`` 1024; GraphSAGE 3 x 256 mean with fanouts [15,
10, 5], the OGB neighbour-sampling baseline's recipe for ogbn-products, and
the GAT with fanouts [10, 5]; 20 steps each, on features that carry the
class, so the loss must fall), the sampler, features and hop adjacencies on
the card; phase 2-host trains GraphSAGE 2 x 256 for 10 steps with
``train.host_features`` on a ``Data(host_arrays=True)``: sampling and the
feature gather on the host, one pinned slab a step to the card, the
evaluation neighbour-sampled through the same loader. Phase 2-stream runs
``graphs/streaming.py``: ``streaming_spmm`` and ``streaming_spmm_grad`` on
the power-law graph in 3 chunks at F=128 (weighted and with ``norm``)
against resident K1 forward and dx, one K1 launch a chunk; then, timed, a
generated graph of about 34 M edges whose edge list stays on the host
(chunks, edges/s, the host's pack ms, the copies' and K1's ms a chunk, the
copies' GB/s beside a pinned copy's). Phase 3 checks the kernel
path against the CPU path on a small graph for GCN, GAT, the blocked GCN,
EncoderGCN (with its BatchNorm buffers), GraphSAGE (mean and max) and GIN,
trains the Kipf GCN (on the CSR and on the blocked layout) and the GAT
recipes on ``cora_like`` into their accuracy bands, and runs the CLI for
every model and for SGD with clipping; it also holds ``forward_sampled``
on the card to the CPU for one node list, runs the CLI on sampled
minibatches and with ``--train.reorder`` 'true' and 'auto', checks that a
run stopped at a checkpoint and resumed equals an uninterrupted one, and
runs ``gnn_tpu_torch.entry.entry()``'s forward on the card against the CPU.

The next-to-last line of standard output is a JSON object with each
kernel's launches (in all, and per training step of each path, the
evaluation's launches left out), error, times, bound and library time (times
over the relabelled graph; ``ms_id_order`` is the same call in id order, the
row earlier versions of this line reported); the last is
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no result. It needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gnn_tpu_torch import native
from gnn_tpu_torch.graphs import Data, build_adjacency, gcn_norm, power_law, to_undirected
from gnn_tpu_torch.graphs.blocked import _diag_product, blocked_matvec, blocked_matvec_plain
from gnn_tpu_torch.graphs.generate import clustered_power_law, cora_like, stochastic_block_model
from gnn_tpu_torch.graphs.sampling import NeighborSampler, hop_adjacencies
from gnn_tpu_torch.graphs.streaming import EdgeStream, streaming_spmm, streaming_spmm_grad
from gnn_tpu_torch.models import GAT, GCN, GIN, EncoderGCN, GraphSAGE
from gnn_tpu_torch.nn import cross_entropy
from gnn_tpu_torch.ops import segment_max, spmm, spmm_edge_weighted
from gnn_tpu_torch.ops.cuda import _build, bounds
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr, segment_sum_csr_plain
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain
from gnn_tpu_torch.ops.cuda.spmm_heads import csr_spmm_heads, csr_spmm_heads_plain
from gnn_tpu_torch.ops.edge_agg import edge_aggregate, edge_aggregate_max
from gnn_tpu_torch.train import Config, fit
from gnn_tpu_torch.train import cli, loop
from gnn_tpu_torch.utils.profiling import H100, Roofline, time_fn

N_NODES = 169_343  # ogbn-arxiv
E_DIRECTED = 1_157_799
IN_FEATURES, NUM_CLASSES = 128, 40
WIDTHS = (40, 128, 256)
GAT_HEADS = ((8, 32), (1, 40))  # (H, F) of the hidden and the output layer
UNWEIGHTED_WIDTHS = (128, 256)  # K1 with a null weight: GIN's input and hidden widths
# (block_rows, block dtype) of phase 1-blocked: fit's default, and the
# configuration of bench.py's blocked workload
BLOCKED_CONFIGS = ((256, None), (512, torch.bfloat16))
BLOCKED_WIDTHS = (256, 40)
# Neighbour-sampled minibatches: the batch, and the fanouts of the GraphSAGE
# (3 layers) and of the GAT and host-feature (2 layers) paths
SAMPLED_BATCH = 1024
SAGE_FANOUTS, GAT_FANOUTS = (15, 10, 5), (10, 5)
# Phase 2-stream: 3 chunks of the arxiv-scale graph at F=128, then the timed
# graph whose edge list stays on the host (halved while its host prep takes
# more than STREAM_PREP_S seconds)
STREAM_F, STREAM_CHUNK, STREAM_TIMED_CHUNK = 128, 1 << 20, 1 << 22
STREAM_NODES, STREAM_DIRECTED_EDGES, STREAM_PREP_S = 2_000_000, 16_000_000, 60.0
# float32: hub rows sum thousands of terms in another order than the plain
# version's atomics. bfloat16: the plain version sums the same bf16 inputs
# in float32 and rounds once, so the two differ by at most one bf16 rounding
# of the output (relative 2^-8), plus the float32 order error near zero.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
KERNELS = {
    "csr_spmm": dict(
        source="gnn_tpu_torch/csrc/csr_spmm.cu",
        replaces="gnn_tpu/ops/pallas/spmm.py:102, gnn_tpu/graphs/blocked.py:650",
    ),
    "segment_sum_csr": dict(
        source="gnn_tpu_torch/csrc/segment_sum.cu",
        replaces="gnn_tpu/ops/pallas/segment.py:192",
    ),
    "csr_spmm_heads": dict(
        source="gnn_tpu_torch/csrc/gat_spmm.cu",
        replaces="gnn_tpu/mp/gat.py:201",
    ),
    # A composition, not a kernel of its own: torch.bmm (the library) over the
    # dense blocks, then K1 over the remainder CSR
    "blocked_matvec": dict(
        source="gnn_tpu_torch/graphs/blocked.py",
        replaces="gnn_tpu/graphs/blocked.py:603",
        composition="torch.bmm over the dense blocks + csr_spmm (gnn_tpu_torch/csrc/csr_spmm.cu) over the remainder",
    ),
}
COUNTERS = {
    "csr_spmm": csr_spmm, "segment_sum_csr": segment_sum_csr, "csr_spmm_heads": csr_spmm_heads,
    "blocked_matvec": blocked_matvec,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(label: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    rtol, atol = TOLERANCE[dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: max abs err {err} outside rtol={rtol} atol={atol}")
    return err


def arxiv_scale_edges() -> np.ndarray:
    """The arxiv-scale benchmark graph (recipe of bench.py), undirected."""
    ei = power_law(N_NODES, E_DIRECTED, alpha=0.8, seed=0)
    ei, _ = to_undirected(ei, num_nodes=N_NODES)
    return ei


def clustered_edges() -> np.ndarray:
    """The clustered arxiv-scale graph (bench.py's blocked workload), undirected."""
    ei = clustered_power_law(N_NODES, E_DIRECTED, avg_community=200, intra_frac=0.85, seed=0)
    ei, _ = to_undirected(ei, num_nodes=N_NODES)
    return ei


def phase0() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log(nvidia_smi())
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, "
        f"built={info['built']}) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", info["log"])]
    if any(spills):
        raise AssertionError(f"ptxas reports register spills: {sum(spills)} bytes")
    if info["built"]:
        log(f"ptxas: {len(spills) // 2} kernels, no spills")
    t0 = time.perf_counter()
    native.load()
    log(f"graph core (g++) build and load: {time.perf_counter() - t0:.2f} s")
    return info


def check_repeat(label: str, kernel, args, got: torch.Tensor) -> None:
    """A second call gives the same bits: the kernels sum in a fixed order,
    with no atomics."""
    if not torch.equal(kernel(*args), got):
        raise AssertionError(f"{label}: a second call gave other bits")


def record(results, name, what, tag, dtype, err, ms, plain_ms, bound, library_ms=None, **shape) -> None:
    """One phase-1 row: the kernel's and the plain version's times, the bound
    of the call (a ``bounds.Bound``) and the library call's time or None."""
    results[name]["rows"].append(dict(
        shape, dtype=str(dtype), what=what, err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound.bound_ms, bound_by=bound.bound_by, noreuse_ms=bound.noreuse_ms, library_ms=library_ms,
    ))
    if dtype == torch.float32:
        results[name]["errs"].append(err)
    library = "none" if library_ms is None else f"{library_ms:.4f}"
    log(f"phase1 {name:16s} {what:15s} {tag:14s} max_abs_err={err:.3e} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound.bound_ms:.4f} ({bound.bound_by}) "
        f"noreuse_ms={bound.noreuse_ms:.4f} library_ms={library}")


def library_ms(label: str, call, got: torch.Tensor) -> float:
    """Time of one PyTorch library call that computes what a kernel does,
    after holding its result to the kernel's (float32 only)."""
    compare(f"{label} library call", call(), got, torch.float32)
    return time_ms(call)


def sparse_csr(row_ptr, col, values, n_cols: int) -> torch.Tensor:
    return torch.sparse_csr_tensor(row_ptr, col, values, size=(row_ptr.numel() - 1, n_cols))


def heads_csr(row_ptr, col, w, n_cols: int) -> torch.Tensor:
    """K3's operator as one CSR matrix [N_rows H, n_cols H] with E H entries:
    row r H + h holds w[k, h] at column col[k] H + h for the edges k of row r
    (w [E, H] in the CSR's edge order), so that its product with x viewed as
    [n_cols H, F] is K3's output viewed as [N_rows H, F]."""
    H = w.shape[1]
    deg = row_ptr.diff()
    rows = torch.repeat_interleave(deg)  # the row of each edge
    start, count = row_ptr[:-1].long()[rows], deg.long()[rows]
    k, h = torch.arange(col.numel(), device=col.device), torch.arange(H, device=col.device)
    # entry (k, h) lies after the row's earlier heads, at the edge's place in the row
    at = (start * H + k - start)[:, None] + h * count[:, None]
    big_col = torch.empty(col.numel() * H, dtype=torch.int32, device=col.device)
    big_col[at] = (col.long()[:, None] * H + h).int()
    big_w = torch.empty_like(big_col, dtype=w.dtype)
    big_w[at] = w
    big_ptr = torch.zeros(deg.numel() * H + 1, dtype=torch.int32, device=col.device)
    big_ptr[1:] = deg.repeat_interleave(H).cumsum(0)
    return torch.sparse_csr_tensor(big_ptr, big_col, big_w, size=(deg.numel() * H, n_cols * H))


def heads_product(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The one library call behind K3's ``library_ms``, on x [N, H, F]."""
    return torch.sparse.mm(a, x.view(-1, x.shape[2])).view(-1, *x.shape[1:])


def phase1(adj, dev, results, by_graph) -> None:
    """K1 and K2 against their plain versions at the GCN's shapes, and
    against a second call of themselves."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n, e = adj.num_dst_nodes, adj.num_edges
    a_fwd = sparse_csr(adj.row_ptr, adj.src, adj.weight, n)
    a_t = sparse_csr(adj.t_row_ptr, adj.t_col, adj.t_weight, n)
    for F in WIDTHS:
        x32 = torch.randn(N_NODES, F, generator=gen, device=dev)
        g32 = torch.randn(N_NODES, F, generator=gen, device=dev)
        # K2's input on the JAX main path: the gathered, weighted messages
        # x[src] * w of spmm_pallas (gnn_tpu/ops/pallas/spmm.py:73-76).
        m32 = x32.index_select(0, adj.src.long()) * adj.weight[:, None]
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"F={F} {str(dtype).removeprefix('torch.')}"
            x, g, msg = x32.to(dtype), g32.to(dtype), m32.to(dtype)

            fwd = csr_spmm(adj.row_ptr, adj.src, adj.weight, x)
            fwd_ref = csr_spmm_plain(adj.row_ptr, adj.src, adj.weight, x)
            e_fwd = compare(f"csr_spmm fwd {tag}", fwd, fwd_ref, dtype)

            xr = x.clone().requires_grad_()
            spmm(adj, xr).backward(g)
            dx_ref = csr_spmm_plain(adj.t_row_ptr, adj.t_col, adj.t_weight, g)
            e_bwd = compare(f"csr_spmm dx {tag}", xr.grad, dx_ref, dtype)

            seg = segment_sum_csr(adj.row_ptr, msg)
            e_seg = compare(f"segment_sum_csr {tag}", seg, segment_sum_csr_plain(adj.row_ptr, msg), dtype)

            check_repeat(f"csr_spmm fwd {tag}", csr_spmm, (adj.row_ptr, adj.src, adj.weight, x), fwd)
            check_repeat(f"csr_spmm dx {tag}", csr_spmm, (adj.t_row_ptr, adj.t_col, adj.t_weight, g), xr.grad)
            check_repeat(f"segment_sum_csr {tag}", segment_sum_csr, (adj.row_ptr, msg), seg)
            log(f"phase1 bitwise repeat {tag}: K1 fwd, K1 dx, K2 equal")

            t = {
                "fwd": (time_ms(lambda: csr_spmm(adj.row_ptr, adj.src, adj.weight, x)),
                        time_ms(lambda: csr_spmm_plain(adj.row_ptr, adj.src, adj.weight, x))),
                "dx": (time_ms(lambda: csr_spmm(adj.t_row_ptr, adj.t_col, adj.t_weight, g)),
                       time_ms(lambda: csr_spmm_plain(adj.t_row_ptr, adj.t_col, adj.t_weight, g))),
                "seg": (time_ms(lambda: segment_sum_csr(adj.row_ptr, msg)),
                        time_ms(lambda: segment_sum_csr_plain(adj.row_ptr, msg))),
            }
            lib = dict.fromkeys(t)
            if dtype == torch.float32:
                lib = {
                    "fwd": library_ms(f"csr_spmm fwd {tag}", lambda: torch.sparse.mm(a_fwd, x), fwd),
                    "dx": library_ms(f"csr_spmm dx {tag}", lambda: torch.sparse.mm(a_t, g), xr.grad),
                    "seg": library_ms(
                        f"segment_sum_csr {tag}",
                        lambda: torch.segment_reduce(msg, "sum", offsets=adj.row_ptr, axis=0, unsafe=True), seg),
                }
            k1_bound = bounds.csr_spmm_bound(n, n, e, F, x.element_size())
            for name, what, err, key, bound in (
                ("csr_spmm", "fwd A@x", e_fwd, "fwd", k1_bound),
                ("csr_spmm", "bwd dx=A^T g", e_bwd, "dx", k1_bound),
                ("segment_sum_csr", "[E,F] -> [N,F]", e_seg, "seg",
                 bounds.segment_sum_bound(n, e, F, x.element_size())),
            ):
                record(results, name, what, tag, dtype, err, *t[key], bound, lib[key], F=F)
            if F == 256 and dtype == torch.float32:
                by_graph["K1"]["power-law"] = graph_stats(adj, t["fwd"][0])

            if dtype == torch.float32:
                w = adj.weight.clone().requires_grad_()
                spmm_edge_weighted(adj, w, x).backward(g)
                src, dst = adj.src.long(), adj.dst.long()
                dw_ref = (g.double()[dst] * x.double()[src]).sum(-1)
                e_dw = compare(f"dw {tag}", w.grad, dw_ref, dtype)
                log(f"phase1 dw (torch SDDMM)  {tag:14s} max_abs_err={e_dw:.3e}")
                del w, dw_ref
            del fwd, fwd_ref, xr, dx_ref, seg, msg
        del x32, g32, m32
        torch.cuda.empty_cache()


def graph_stats(adj, ms: float) -> dict:
    return dict(edges=adj.num_edges, max_in_degree=int(adj.row_ptr.diff().max()), ms=ms)


def log_by_graph(label: str, stats: dict) -> None:
    """A kernel's time should follow the edge count, not the longest row."""
    pl, cl = stats["power-law"], stats["clustered"]
    log(f"phase1 {label} float32 by graph: power-law {json.dumps(pl)}, clustered {json.dumps(cl)}; "
        f"time ratio {pl['ms'] / cl['ms']:.3f}, edge ratio {pl['edges'] / cl['edges']:.3f}, "
        f"max in-degree ratio {pl['max_in_degree'] / cl['max_in_degree']:.3f}")


def phase1_blocked(edges: np.ndarray, dev, results, by_graph) -> None:
    """blocked_matvec (the block product, then K1 over the remainder CSR)
    against its plain version, forward and transpose, at the GCN's widths;
    the float32 configuration also against K1 over the whole relabelled CSR
    of the same graph. Times: blocked, its plain version, the block product
    alone, K1 over the remainder alone (beside its bound), and K1 over the
    whole CSR; K3's (8, 32) forward over that CSR is held against its plain
    version and timed for the by-graph line."""
    ei, w = gcn_norm(edges, num_nodes=N_NODES, self_loops=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    for rows, block_dtype in BLOCKED_CONFIGS:
        t0 = time.perf_counter()
        adj = build_adjacency(ei, w, num_nodes=N_NODES, reorder="cluster", block_rows=rows,
                              block_dtype=block_dtype)
        prep = time.perf_counter() - t0
        adj = adj.to(dev)
        cfg = f"R={rows} {str(adj.blocked.diag.dtype).removeprefix('torch.')}"
        for name in ("blocked", "t_blocked"):
            lay = getattr(adj, name)
            dense = lay.num_dense_edges
            log(f"phase1-blocked {cfg} {name}: windows={lay.num_blocks} dense_edges={dense} "
                f"({dense / adj.num_edges:.1%}) remainder_edges={lay.num_rem_edges} "
                f"max_remainder_in_degree={int(lay.rem_row_ptr.diff().max())} "
                f"max_in_degree={int(adj.row_ptr.diff().max())} prep_s={prep:.2f}")
        for F in BLOCKED_WIDTHS:
            x = torch.randn(N_NODES, F, generator=gen, device=dev)
            g = torch.randn(N_NODES, F, generator=gen, device=dev)
            cases = (
                ("fwd A@x", adj.blocked, x, (adj.row_ptr, adj.src, adj.weight)),
                ("dx=A^T g", adj.t_blocked, g, (adj.t_row_ptr, adj.t_col, adj.t_weight)),
            )
            for what, lay, v, csr in cases:
                tag = f"{cfg} F={F} {what}"
                got = blocked_matvec(lay, v)
                err = compare(f"blocked_matvec {tag}", got, blocked_matvec_plain(lay, v), torch.float32)
                ms = time_ms(lambda: blocked_matvec(lay, v))
                plain_ms = time_ms(lambda: blocked_matvec_plain(lay, v))
                xw = torch.nn.functional.pad(v, (0, 0, 0, lay.diag.shape[0] * rows - N_NODES))
                xw = xw.view(-1, rows, F).to(lay.diag.dtype)
                diag_ms = time_ms(lambda: _diag_product(lay.diag, xw))
                rem_ms = time_ms(lambda: csr_spmm(lay.rem_row_ptr, lay.rem_src, lay.rem_w, v))
                rem_bound = bounds.csr_spmm_bound(N_NODES, N_NODES, lay.num_rem_edges, F, v.element_size())
                # The function's bound (A @ x over every edge) and, beside it, what the
                # layout asks for: every block entry multiplied, zero or not.
                bound = bounds.blocked_matvec_bound(N_NODES, adj.num_edges, F, v.element_size())
                layout_ms = bounds.blocked_layout_cost_ms(
                    lay.num_blocks, rows, lay.diag.element_size(), N_NODES, lay.num_rem_edges, F, v.element_size())
                line = (f"phase1-blocked {tag:28s} max_abs_err={err:.3e} blocked_ms={ms:.4f} "
                        f"plain_ms={plain_ms:.4f} bound_ms={bound.bound_ms:.4f} ({bound.bound_by}) "
                        f"layout_cost_ms={layout_ms:.4f} bmm_ms={diag_ms:.4f} k1_remainder_ms={rem_ms:.4f} "
                        f"k1_remainder_bound_ms={rem_bound.bound_ms:.4f} "
                        f"k1_remainder_noreuse_ms={rem_bound.noreuse_ms:.4f}")
                lib = None
                if block_dtype is None:
                    a_csr = sparse_csr(*csr, N_NODES)
                    lib = library_ms(f"blocked_matvec {tag}", lambda: torch.sparse.mm(a_csr, v), got)
                    line += f" library_ms={lib:.4f}"
                    full = csr_spmm(*csr, v)
                    err_csr = compare(f"blocked_matvec vs full-CSR K1 {tag}", got, full, torch.float32)
                    check_repeat(f"full-CSR K1 {tag}", csr_spmm, (*csr, v), full)
                    csr_ms = time_ms(lambda: csr_spmm(*csr, v))
                    line += f" k1_full_csr_ms={csr_ms:.4f} err_vs_full_csr={err_csr:.3e}"
                    if F == 256 and lay is adj.blocked:
                        by_graph["K1"]["clustered"] = graph_stats(adj, csr_ms)
                        by_graph["K3"]["clustered"] = graph_stats(adj, k3_forward_ms(adj, v, gen))
                log(line)
                results["csr_spmm"]["rows"].append(dict(
                    F=F, dtype="torch.float32", what=f"blocked {what} {cfg}", err=err, ms=ms, plain_ms=plain_ms,
                ))
                results["csr_spmm"]["errs"].append(err)
                results["blocked_matvec"]["rows"].append(dict(
                    F=F, dtype="torch.float32", what=f"{what} {cfg}", err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound.bound_ms, bound_by=bound.bound_by, noreuse_ms=bound.noreuse_ms, library_ms=lib,
                    layout_cost_ms=layout_ms,
                ))
                results["blocked_matvec"]["errs"].append(err)
            del x, g
        del adj
        torch.cuda.empty_cache()


def k3_forward_ms(adj, x2: torch.Tensor, gen) -> float:
    """K3's forward at GAT's hidden shape over ``adj``'s CSR, x2 [N, H * F]
    float32: checked against the plain version and a second call, then timed."""
    H, F = GAT_HEADS[0]
    _, alpha = attention_weights(adj, H, gen)
    args = (adj.row_ptr, adj.src, alpha, x2.view(-1, H, F))
    got = csr_spmm_heads(*args)
    compare("csr_spmm_heads fwd, clustered graph", got, csr_spmm_heads_plain(*args), torch.float32)
    check_repeat("csr_spmm_heads fwd, clustered graph", csr_spmm_heads, args, got)
    return time_ms(lambda: csr_spmm_heads(*args))


def attention_weights(adj, H: int, gen) -> tuple:
    """GAT's edge weights on the main path: ex = exp(e - max over the
    destination's in-edges) of random scores e [E, H], and the normalized
    alpha = ex / sum of ex per destination, whose weighted sums are O(1)."""
    e = torch.randn(adj.num_edges, H, generator=gen, device=adj.device)
    m = segment_max(e, adj.dst, adj.num_dst_nodes).index_select(0, adj.dst.long())
    ex = torch.exp(e - m)
    den = segment_sum_csr_plain(adj.row_ptr, ex)
    return ex, ex / den.index_select(0, adj.dst.long())


def phase1_gat(adj, dev, results, by_graph) -> None:
    """K3, K2 and K1 against their plain versions at the GAT's shapes. K3's
    transpose reads its weights in place through ``w_index = t_perm``, as
    the training path's backward does."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n, e = adj.num_dst_nodes, adj.num_edges
    ones = torch.ones(e, device=dev)
    for H, F in GAT_HEADS:
        ex, alpha = attention_weights(adj, H, gen)
        x32 = torch.randn(n, H, F, generator=gen, device=dev)
        # Positive cotangents for the transpose: a hub source sums 21,305
        # terms, and without cancellation the two summation orders agree to
        # a relative float32 error.
        g32 = torch.rand(n, H, F, generator=gen, device=dev)
        # the cotangent of the gathered a_src . h, here GCN-weighted noise so
        # that a hub's sum stays O(1)
        ge32 = torch.randn(e, H, generator=gen, device=dev) * adj.weight[:, None]
        # K3 as one library call: a CSR product over the heads' expanded CSR
        a_fwd = heads_csr(adj.row_ptr, adj.src, alpha, n)
        a_t = heads_csr(adj.t_row_ptr, adj.t_col, alpha.index_select(0, adj.t_perm.long()), n)
        a_perm = sparse_csr(adj.t_row_ptr, adj.t_perm, ones, e)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"H={H} F={F} {str(dtype).removeprefix('torch.')}"
            x, g, ge, exd = x32.to(dtype), g32.to(dtype), ge32.to(dtype), ex.to(dtype)
            size = x.element_size()
            cases = (
                ("csr_spmm_heads", "fwd num", csr_spmm_heads, csr_spmm_heads_plain,
                 (adj.row_ptr, adj.src, alpha, x), bounds.csr_spmm_heads_bound(n, n, e, H, F, size),
                 lambda: heads_product(a_fwd, x)),
                ("csr_spmm_heads", "bwd dh", csr_spmm_heads, csr_spmm_heads_plain,
                 (adj.t_row_ptr, adj.t_col, alpha, g, adj.t_perm),
                 bounds.csr_spmm_heads_bound(n, n, e, H, F, size, indexed=True),
                 lambda: heads_product(a_t, g)),
                ("segment_sum_csr", f"den [E,{H}]", segment_sum_csr, segment_sum_csr_plain,
                 (adj.row_ptr, exd), bounds.segment_sum_bound(n, e, H, size),
                 lambda: torch.segment_reduce(exd, "sum", offsets=adj.row_ptr, axis=0, unsafe=True)),
                ("csr_spmm", "gather_src VJP", csr_spmm, csr_spmm_plain,
                 (adj.t_row_ptr, adj.t_perm, None, ge), bounds.csr_spmm_bound(n, e, e, H, size, weighted=False),
                 lambda: torch.sparse.mm(a_perm, ge)),
            )
            ms = check_cases(results, cases, tag, dtype, H=H, F=F)
            if (H, dtype) == (GAT_HEADS[0][0], torch.float32):
                by_graph["K3"]["power-law"] = graph_stats(adj, ms["csr_spmm_heads", "fwd num"])
            log(f"phase1 bitwise repeat {tag}: K3 fwd, K3 dh, K2, K1 equal")
        del ex, alpha, x32, g32, ge32, a_fwd, a_t, a_perm
        torch.cuda.empty_cache()


def phase1_unweighted(adj, dev, results) -> None:
    """K1 with a null weight (GIN's plain neighbour sum), forward and
    transpose at GIN's widths, against its plain version, a second call and,
    in float32, ``torch.sparse.mm`` over a CSR of ones. Positive inputs in
    [0, 1/256): a hub sums 21,305 unscaled rows (to about 40 here), and
    without cancellation the two summation orders agree to a relative
    float32 error."""
    gen = torch.Generator(device=dev).manual_seed(3)
    n, e = adj.num_dst_nodes, adj.num_edges
    ones = torch.ones(e, device=dev)
    a_fwd = sparse_csr(adj.row_ptr, adj.src, ones, n)
    a_t = sparse_csr(adj.t_row_ptr, adj.t_col, ones, n)
    for F in UNWEIGHTED_WIDTHS:
        x32 = torch.rand(n, F, generator=gen, device=dev) / 256
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"F={F} {str(dtype).removeprefix('torch.')}"
            x = x32.to(dtype)
            bound = bounds.csr_spmm_bound(n, n, e, F, x.element_size(), weighted=False)
            check_cases(results, (
                ("csr_spmm", "fwd A@x, w null", csr_spmm, csr_spmm_plain, (adj.row_ptr, adj.src, None, x), bound,
                 lambda: torch.sparse.mm(a_fwd, x)),
                ("csr_spmm", "bwd dx, w null", csr_spmm, csr_spmm_plain, (adj.t_row_ptr, adj.t_col, None, x), bound,
                 lambda: torch.sparse.mm(a_t, x)),
            ), tag, dtype, F=F)
            log(f"phase1 bitwise repeat {tag}: K1 fwd and dx with a null weight equal")
        del x32
        torch.cuda.empty_cache()


def check_cases(results, cases, tag: str, dtype, **shape) -> dict:
    """Each case (kernel name, what, kernel, plain version, args, bound,
    library call): the kernel against its plain version and a second call of
    itself, its time, the plain version's and, in float32, the library
    call's, as one phase-1 row. Returns the kernel's ms by (name, what)."""
    times = {}
    for name, what, kernel, plain, args, bound, library in cases:
        got = kernel(*args)
        err = compare(f"{name} {what} {tag}", got, plain(*args), dtype)
        check_repeat(f"{name} {what} {tag}", kernel, args, got)
        lib = library_ms(f"{name} {what} {tag}", library, got) if dtype == torch.float32 else None
        times[name, what] = time_ms(lambda: kernel(*args))
        record(results, name, what, tag, dtype, err, times[name, what],
               time_ms(lambda: plain(*args)), bound, lib, **shape)
    return times


def hop_names(n: int) -> tuple:
    """Names of a path's 2 or 3 hops, outermost first."""
    return ("outer", "middle")[:n - 1] + ("inner",)


def phase1_hop(dev, results) -> None:
    """K1, K2 and K3 over the constant bipartite CSRs of neighbour-sampled
    hops, at every shape that phases 2-sampled-sage, 2-sampled-gat and
    2-host launch them at: each hop of each path at the width and with the
    operand the model gives it, forward on every hop, K1's transpose on all
    but the outermost (whose input is gathered data and needs no gradient).
    Forward, every one of the n_dst rows holds exactly ``fanout`` edges and
    ``col`` is contiguous from n_dst: the gather is a streamed read, so the
    no-reuse figure equals the bound. Transposed, n_dst leading rows hold no
    edge and each of the E others exactly one."""
    gen = torch.Generator(device=dev).manual_seed(4)
    # GraphSAGE: (path, fanouts, width of each hop's input, outermost first)
    for path, fanouts, widths in (
        ("sage", SAGE_FANOUTS, (IN_FEATURES, 256, 256)), ("host", GAT_FANOUTS, (IN_FEATURES, 256)),
    ):
        hops = hop_adjacencies(SAMPLED_BATCH, fanouts)
        for label, adj, F in zip(hop_names(len(hops)), hops, widths):
            adj = adj.to(dev)
            n_dst, n_src, e = adj.num_dst_nodes, adj.num_src_nodes, adj.num_edges
            log(f"phase1-hop GraphSAGE ({path}) {label} hop of batch {SAMPLED_BATCH}, fanouts {list(fanouts)}: "
                f"{n_dst} destinations x {e // n_dst} = {e} edges over {n_src} sources, F={F}")
            ones = torch.ones(e, device=dev)
            a_fwd = sparse_csr(adj.row_ptr, adj.src, ones, n_src)
            a_t = sparse_csr(adj.t_row_ptr, adj.t_col, ones, n_dst)
            x32 = torch.randn(n_src, F, generator=gen, device=dev)
            g32 = torch.randn(n_dst, F, generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{path}-{label} F={F} {str(dtype).removeprefix('torch.')}"
                x, g = x32.to(dtype), g32.to(dtype)
                size = x.element_size()
                cases = [
                    ("csr_spmm", "hop fwd, w null", csr_spmm, csr_spmm_plain, (adj.row_ptr, adj.src, None, x),
                     bounds.csr_spmm_bound(n_dst, n_src, e, F, size, weighted=False),
                     lambda: torch.sparse.mm(a_fwd, x)),
                ]
                if label != "outer":
                    cases.append(
                        ("csr_spmm", "hop dx, w null", csr_spmm, csr_spmm_plain, (adj.t_row_ptr, adj.t_col, None, g),
                         bounds.csr_spmm_bound(n_src, n_dst, e, F, size, weighted=False),
                         lambda: torch.sparse.mm(a_t, g)))
                check_cases(results, cases, tag, dtype, F=F, hop=f"{path}-{label}", edges=e)
                log(f"phase1-hop bitwise repeat {tag}: K1 {' and '.join(what for _, what, *_ in cases)} equal")
            del x32, g32, a_fwd, a_t

    # The GAT: the hidden layer's (H, F) on the outer hop, the output layer's on the inner
    hops = hop_adjacencies(SAMPLED_BATCH, GAT_FANOUTS)
    for label, adj, (H, F) in zip(hop_names(len(hops)), hops, GAT_HEADS):
        adj = adj.to(dev)
        n_dst, n_src, e = adj.num_dst_nodes, adj.num_src_nodes, adj.num_edges
        log(f"phase1-hop GAT {label} hop of batch {SAMPLED_BATCH}, fanouts {list(GAT_FANOUTS)}: "
            f"{n_dst} destinations x {e // n_dst} = {e} edges over {n_src} sources, (H,F)=({H},{F})")
        ex, alpha = attention_weights(adj, H, gen)
        x32 = torch.randn(n_src, H, F, generator=gen, device=dev)
        g32 = torch.randn(n_dst, H, F, generator=gen, device=dev)
        ge32 = torch.randn(e, H, generator=gen, device=dev)
        a_fwd = heads_csr(adj.row_ptr, adj.src, alpha, n_src)
        a_t = heads_csr(adj.t_row_ptr, adj.t_col, alpha.index_select(0, adj.t_perm.long()), n_dst)
        a_perm = sparse_csr(adj.t_row_ptr, adj.t_perm, torch.ones(e, device=dev), e)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"gat-{label} H={H} F={F} {str(dtype).removeprefix('torch.')}"
            x, g, ge, exd = x32.to(dtype), g32.to(dtype), ge32.to(dtype), ex.to(dtype)
            size = x.element_size()
            check_cases(results, (
                ("csr_spmm_heads", "hop fwd num", csr_spmm_heads, csr_spmm_heads_plain,
                 (adj.row_ptr, adj.src, alpha, x), bounds.csr_spmm_heads_bound(n_dst, n_src, e, H, F, size),
                 lambda: heads_product(a_fwd, x)),
                ("csr_spmm_heads", "hop bwd dh", csr_spmm_heads, csr_spmm_heads_plain,
                 (adj.t_row_ptr, adj.t_col, alpha, g, adj.t_perm),
                 bounds.csr_spmm_heads_bound(n_src, n_dst, e, H, F, size, indexed=True),
                 lambda: heads_product(a_t, g)),
                ("segment_sum_csr", f"hop den [E,{H}]", segment_sum_csr, segment_sum_csr_plain,
                 (adj.row_ptr, exd), bounds.segment_sum_bound(n_dst, e, H, size),
                 lambda: torch.segment_reduce(exd, "sum", offsets=adj.row_ptr, axis=0, unsafe=True)),
                ("csr_spmm", "hop gather_src VJP", csr_spmm, csr_spmm_plain,
                 (adj.t_row_ptr, adj.t_perm, None, ge), bounds.csr_spmm_bound(n_src, e, e, H, size, weighted=False),
                 lambda: torch.sparse.mm(a_perm, ge)),
            ), tag, dtype, H=H, F=F, hop=f"gat-{label}", edges=e)
            log(f"phase1-hop bitwise repeat {tag}: K3 fwd, K3 dh, K2, K1 equal")
        del ex, alpha, x32, g32, ge32, a_fwd, a_t, a_perm
    torch.cuda.empty_cache()


def id_order_row(results, name: str, what: str, **shape) -> dict:
    """The float32 row of ``name`` in id order (phases 1, 1-gat, 1-unweighted)
    with this ``what`` and shape."""
    return next(
        r for r in results[name]["rows"]
        if r["dtype"] == "torch.float32" and r["what"] == what and r.get("graph") is None
        and all(r.get(k) == v for k, v in shape.items())
    )


def phase1_relabel(adj, dev, results) -> None:
    """The kernels over the degree-bucket relabelled CSR of the power-law
    graph, the node order fit's default ``train.reorder='auto'`` trains in:
    K1 forward and dx at the GCN's widths and with a null weight at F=128,
    K3 forward at (8, 32), K2 at [E, 8]; float32, each against its plain
    version, a second call and ``torch.sparse.mm`` / ``torch.segment_reduce``
    over the same relabelled CSR. Each row is then printed beside the row of
    the same call in id order from phase 1, 1-gat or 1-unweighted."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, e = adj.num_dst_nodes, adj.num_edges
    dtype = torch.float32
    a_fwd = sparse_csr(adj.row_ptr, adj.src, adj.weight, n)
    a_t = sparse_csr(adj.t_row_ptr, adj.t_col, adj.t_weight, n)
    ones = torch.ones(e, device=dev)
    a_ones = sparse_csr(adj.row_ptr, adj.src, ones, n)
    compared = []
    for F in WIDTHS:
        x = torch.randn(n, F, generator=gen, device=dev)
        g = torch.randn(n, F, generator=gen, device=dev)
        bound = bounds.csr_spmm_bound(n, n, e, F, 4)
        cases = [
            ("csr_spmm", "fwd A@x", csr_spmm, csr_spmm_plain, (adj.row_ptr, adj.src, adj.weight, x), bound,
             lambda: torch.sparse.mm(a_fwd, x)),
            ("csr_spmm", "bwd dx=A^T g", csr_spmm, csr_spmm_plain, (adj.t_row_ptr, adj.t_col, adj.t_weight, g), bound,
             lambda: torch.sparse.mm(a_t, g)),
        ]
        if F == 128:
            xu = torch.rand(n, F, generator=gen, device=dev) / 256  # as phase1_unweighted's inputs
            cases.append(("csr_spmm", "fwd A@x, w null", csr_spmm, csr_spmm_plain, (adj.row_ptr, adj.src, None, xu),
                          bounds.csr_spmm_bound(n, n, e, F, 4, weighted=False), lambda: torch.sparse.mm(a_ones, xu)))
        check_cases(results, cases, f"relabelled F={F} float32", dtype, F=F, graph="relabelled")
        compared += [(name, what, dict(F=F)) for name, what, *_ in cases]
        del x, g
    H, F = GAT_HEADS[0]
    ex, alpha = attention_weights(adj, H, gen)
    x = torch.randn(n, H, F, generator=gen, device=dev)
    a_heads = heads_csr(adj.row_ptr, adj.src, alpha, n)
    check_cases(results, (
        ("csr_spmm_heads", "fwd num", csr_spmm_heads, csr_spmm_heads_plain, (adj.row_ptr, adj.src, alpha, x),
         bounds.csr_spmm_heads_bound(n, n, e, H, F, 4), lambda: heads_product(a_heads, x)),
        ("segment_sum_csr", f"den [E,{H}]", segment_sum_csr, segment_sum_csr_plain, (adj.row_ptr, ex),
         bounds.segment_sum_bound(n, e, H, 4),
         lambda: torch.segment_reduce(ex, "sum", offsets=adj.row_ptr, axis=0, unsafe=True)),
    ), f"relabelled H={H} F={F} float32", dtype, H=H, F=F, graph="relabelled")
    compared += [("csr_spmm_heads", "fwd num", dict(H=H, F=F)), ("segment_sum_csr", f"den [E,{H}]", dict(H=H))]
    log("phase1-relabel bitwise repeat: every K1, K3 and K2 row equal")
    for name, what, shape in compared:
        new = next(r for r in reversed(results[name]["rows"]) if r.get("graph") == "relabelled"
                   and r["what"] == what and all(r.get(k) == v for k, v in shape.items()))
        old = id_order_row(results, name, what, **shape)
        log(f"phase1-relabel {name:15s} {what:16s} {json.dumps(shape)}: relabelled kernel_ms={new['ms']:.4f} "
            f"library_ms={new['library_ms']:.4f} plain_ms={new['plain_ms']:.4f} | id order kernel_ms={old['ms']:.4f} "
            f"library_ms={old['library_ms']:.4f} plain_ms={old['plain_ms']:.4f} | bound_ms={new['bound_ms']:.4f} "
            f"noreuse_ms={new['noreuse_ms']:.4f} (id order {old['noreuse_ms']:.4f}); "
            f"relabelled / id order {new['ms'] / old['ms']:.3f}")
    del ex, alpha, x, a_heads, a_fwd, a_t, a_ones
    torch.cuda.empty_cache()


def profiling_on_card(adj, dev) -> None:
    """``utils.profiling``: ``time_fn`` (CUDA events) times one K1 forward at
    F=256 over the relabelled CSR and ``Roofline(chip=H100)`` scores it; its
    memory time must equal ``ops/cuda/bounds.py``'s compulsory bound."""
    n, e, F = adj.num_dst_nodes, adj.num_edges, 256
    x = torch.randn(n, F, device=dev)
    secs = time_fn(csr_spmm, adj.row_ptr, adj.src, adj.weight, x, iters=20, warmup=3)
    roof = Roofline(chip=H100).add_read(
        ((n + 1,), np.int32), ((e,), np.int32), ((e,), np.float32), ((n, F), np.float32))
    roof.add_write(((n, F), np.float32))
    bound = bounds.csr_spmm_bound(n, n, e, F, 4)
    if not math.isclose(roof.memory_time_s * 1e3, bound.bytes_ms, rel_tol=1e-9):
        raise AssertionError(f"Roofline memory time {roof.memory_time_s * 1e3} ms != bound {bound.bytes_ms} ms")
    log(f"phase1-relabel utils.profiling: time_fn K1 F=256 fwd {secs * 1e3:.4f} ms; Roofline(chip={H100.name}) "
        f"memory time {roof.memory_time_s * 1e3:.4f} ms, fraction of peak {roof.fraction_of_peak(secs, 'float32'):.3f}")


def phase1_edge_agg(adj, dev, results) -> None:
    """``ops.edge_agg`` over the relabelled adjacency's edge-position CSRs:
    ``edge_aggregate`` over the identity positions (``edge_agg``, one K2
    launch) and over ``t_perm`` (``t_edge_agg``, one K1 launch with a null
    weight) at [E, 8] and [E, 1], against the plain versions, a second call
    and the library, with the launches of one call counted; and
    ``edge_aggregate_max`` (plain torch on every device) against
    ``segment_max`` by the same nodes, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(6)
    n, e = adj.num_dst_nodes, adj.num_edges
    a_perm = sparse_csr(adj.t_row_ptr, adj.t_perm, torch.ones(e, device=dev), e)
    for H in (8, 1):
        msg = torch.randn(e, H, generator=gen, device=dev) * adj.weight[:, None]
        plain_fwd = lambda m, lay: segment_sum_csr_plain(lay.row_ptr, m)
        plain_t = lambda m, lay: csr_spmm_plain(lay.row_ptr, lay.positions, None, m)
        cases = (
            ("segment_sum_csr", f"edge_aggregate [E,{H}]", edge_aggregate, plain_fwd, (msg, adj.edge_agg),
             bounds.segment_sum_bound(n, e, H, 4),
             lambda: torch.segment_reduce(msg, "sum", offsets=adj.row_ptr, axis=0, unsafe=True)),
            ("csr_spmm", f"edge_aggregate t_perm [E,{H}]", edge_aggregate, plain_t, (msg, adj.t_edge_agg),
             bounds.csr_spmm_bound(n, e, e, H, 4, weighted=False), lambda: torch.sparse.mm(a_perm, msg)),
        )
        for name, what, _, _, args, _, _ in cases:
            before = read_counters()
            edge_aggregate(*args)
            took = {k: v - before[k] for k, v in read_counters().items() if v != before[k]}
            log(f"phase1-edge-agg {what}: one call launched {took}")
            if took != {name: 1}:
                raise AssertionError(f"phase1-edge-agg {what}: launched {took}, not {name} once")
        check_cases(results, cases, f"relabelled H={H} float32", torch.float32, H=H, graph="relabelled")
        for lay, ids, label in ((adj.edge_agg, adj.dst, "by destination"), (adj.t_edge_agg, adj.src, "by source")):
            got = edge_aggregate_max(msg, lay)
            if not torch.equal(got, segment_max(msg, ids, n)):
                raise AssertionError(f"phase1-edge-agg edge_aggregate_max [E,{H}] {label} differs from segment_max")
            log(f"phase1-edge-agg edge_aggregate_max [E,{H}] {label}: equals segment_max bit for bit, "
                f"{int(torch.isneginf(got[:, 0]).sum())} empty rows -inf, "
                f"ms={time_ms(lambda: edge_aggregate_max(msg, lay)):.4f} (plain torch, no kernel)")
        del msg
    del a_perm
    torch.cuda.empty_cache()


def arxiv_scale_data(edges: np.ndarray, signal: float = 0.0, host_arrays: bool = False) -> Data:
    """Seeded 128-dim features, 40 classes and a 54/18/28 % split (the
    proportions of ogbn-arxiv) on the arxiv-scale graph. ``signal`` adds that
    multiple of a seeded per-class centroid to the noise features, so that a
    few steps can lower the loss; ``host_arrays`` keeps everything in numpy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_NODES, IN_FEATURES)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, N_NODES)
    if signal:
        centroids = np.random.default_rng(1).normal(size=(NUM_CLASSES, IN_FEATURES)).astype(np.float32)
        x += np.float32(signal) * centroids[y]
    perm = rng.permutation(N_NODES)
    n_train, n_val = int(0.54 * N_NODES), int(0.18 * N_NODES)
    masks = {k: np.zeros(N_NODES, bool) for k in ("train", "val", "test")}
    masks["train"][perm[:n_train]] = True
    masks["val"][perm[n_train : n_train + n_val]] = True
    masks["test"][perm[n_train + n_val :]] = True
    return Data(
        x=x, edge_index=edges, y=y, num_nodes=N_NODES,
        train_mask=masks["train"], val_mask=masks["val"], test_mask=masks["test"], host_arrays=host_arrays,
    )


def arxiv_gcn_config(epochs: int = 5) -> Config:
    """GCN 3 x 256, dropout 0.5, Adam lr 0.01: the OGB GCN baseline for arxiv."""
    cfg = Config()
    cfg.model.name, cfg.model.num_layers, cfg.model.hidden, cfg.model.dropout = "gcn", 3, 256, 0.5
    cfg.optim.name, cfg.optim.lr = "adam", 0.01
    cfg.train.epochs, cfg.train.eval_every = epochs, 1
    return cfg


def arxiv_gat_config(epochs: int = 5) -> Config:
    """GAT 2 layers, 8 heads x 32 (hidden 256), 1 output head over the 40
    classes: the repo's GAT at the width of benchmarks/e2e.py:104. Dropout
    0.5, Adam lr 0.005."""
    cfg = Config()
    cfg.model.name, cfg.model.num_layers, cfg.model.hidden, cfg.model.heads = "gat", 2, 32, 8
    cfg.model.dropout = 0.5
    cfg.optim.name, cfg.optim.lr = "adam", 0.005
    cfg.train.epochs, cfg.train.eval_every = epochs, 1
    return cfg


def arxiv_encoder_config(epochs: int = 5) -> Config:
    """The reference's flagship recipe at arxiv's widths: pre-MLP 128 -> 256
    -> 128, two GCNConv with the BatchNorm/ReLU mid-block at 128 and tanh,
    post-MLP 128 -> 40. Dropout 0.5, Adam lr 0.01."""
    cfg = Config()
    cfg.model.name, cfg.model.num_layers, cfg.model.dropout = "encoder_gcn", 2, 0.5
    cfg.optim.name, cfg.optim.lr = "adam", 0.01
    cfg.train.epochs, cfg.train.eval_every = epochs, 1
    return cfg


def arxiv_sage_config(epochs: int = 5) -> Config:
    """GraphSAGE 3 x 256, mean aggregator, dropout 0.5, Adam lr 0.01: the
    OGB GraphSAGE baseline's width for arxiv."""
    cfg = Config()
    cfg.model.name, cfg.model.num_layers, cfg.model.hidden, cfg.model.dropout = "sage", 3, 256, 0.5
    cfg.model.aggr = "mean"
    cfg.optim.name, cfg.optim.lr = "adam", 0.01
    cfg.train.epochs, cfg.train.eval_every = epochs, 1
    return cfg


def arxiv_gin_config(epochs: int = 5) -> Config:
    """GIN 3 x 256 under SGD (momentum 0.9, lr 0.01) with the gradients'
    global norm clipped to 1."""
    cfg = Config()
    cfg.model.name, cfg.model.num_layers, cfg.model.hidden = "gin", 3, 256
    cfg.optim.name, cfg.optim.lr, cfg.optim.momentum, cfg.optim.grad_clip = "sgd", 0.01, 0.9, 1.0
    cfg.train.epochs, cfg.train.eval_every = epochs, 1
    return cfg


def arxiv_sampled_config(model: str, fanouts, steps: int, host_features: bool = False) -> Config:
    """The arxiv-scale recipe of ``model`` on neighbour-sampled minibatches of
    1024 seeds: one layer per fanout, one batch a step, evaluated after
    every step (the host-feature path, whose evaluation is neighbour-sampled
    on the host too, after every fifth)."""
    cfg = {"sage": arxiv_sage_config, "gat": arxiv_gat_config}[model](steps)
    cfg.model.num_layers = len(fanouts)
    cfg.train.batch_size, cfg.train.fanouts, cfg.train.host_features = SAMPLED_BATCH, list(fanouts), host_features
    cfg.train.eval_every = 5 if host_features else 1
    return cfg


def read_counters() -> dict:
    return {name: counter.launches for name, counter in COUNTERS.items()}


def train_phase(
    label: str, cfg: Config, data: Data, dev, want: dict, check=None, falling: bool = False, want_perm=None
) -> tuple:
    """Train through ``fit`` with every launch counter at 0 just before and
    read just after; check finite losses (``falling``: the mean of the last
    quarter below that of the first) and the launches per kernel. Returns
    the launches in all and those of one training step: the counters are
    also read around each of ``fit``'s evaluations (full-graph or
    neighbour-sampled on the host), whose launches are taken off before
    dividing by the epochs. ``check(model, state, history)`` looks at what
    ``fit`` returned. The step that ``fit`` builds is captured too, to
    print whether its adjacency was relabelled (``perm`` present) and, where
    ``want_perm`` is given, to check it."""
    in_eval = dict.fromkeys(COUNTERS, 0)
    originals = {"evaluate": loop.evaluate, "host_evaluate": loop.host_evaluate}
    build_step, steps = loop.build_step, []

    def counted(evaluate):
        def run(*args):
            before = read_counters()
            out = evaluate(*args)
            for name, count in read_counters().items():
                in_eval[name] += count - before[name]
            return out
        return run

    def captured(*args):
        steps.append(build_step(*args))
        return steps[-1]

    for counter in COUNTERS.values():
        counter.launches = 0
    for name, evaluate in originals.items():
        setattr(loop, name, counted(evaluate))
    loop.build_step = captured
    try:
        model, state, history = fit(cfg, data, device=dev, verbose=False)
    finally:
        for name, evaluate in originals.items():
            setattr(loop, name, evaluate)
        loop.build_step = build_step
    launches = read_counters()
    adj = steps[0].adj
    perm = adj is not None and adj.perm is not None
    log(f"{label} train.reorder={cfg.train.reorder}: perm {'present' if perm else 'absent'}"
        + ("" if adj is None else f", layout {adj.layout}"))
    if want_perm is not None and perm != want_perm:
        raise AssertionError(f"{label}: perm {'present' if perm else 'absent'}, expected the opposite")
    if check is not None:
        check(model, state, history)
    per_step = {name: (launches[name] - in_eval[name]) / cfg.train.epochs for name in COUNTERS}

    losses = [h["loss"] for h in history]
    step_ms = [h["step_ms"] for h in history]
    logged = cfg.train.epochs // cfg.train.eval_every
    log(f"{label} losses per logged step: {losses}")
    log(f"{label} step ms per logged step (synced): {step_ms}")
    median_ms = float(np.median(step_ms[1:]))
    log(f"{label} median step ms over logged steps 2-{logged}: {median_ms:.3f}")
    log(f"{label} launches: {launches} (expected {want}); per training step: {per_step}")
    if len(losses) != logged or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: expected {logged} finite losses, got {losses}")
    quarter = max(len(losses) // 4, 1)
    if falling and not np.mean(losses[-quarter:]) < np.mean(losses[:quarter]):
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return launches, per_step, median_ms


def phase2(data: Data, dev) -> tuple:
    """The GCN main path: full-graph training at arxiv scale. Each epoch
    runs K1 once a layer forward, once a layer backward (dx of the layer's
    Linear output) and once a layer in the evaluation."""
    cfg = arxiv_gcn_config()
    n = cfg.train.epochs * cfg.model.num_layers
    return train_phase("phase2", cfg, data, dev, k1_only(3 * n), want_perm=True)


def phase2_orders(data: Data, dev, auto_ms: float) -> dict:
    """The GCN of phase 2 again with ``train.reorder='false'`` (the node ids
    kept) and ``'true'`` (the relabelling forced), so that both orders have
    a ``step_ms`` from this run; the launches do not depend on the order."""
    n = arxiv_gcn_config().train.epochs * arxiv_gcn_config().model.num_layers
    out, ms = {}, {"auto": auto_ms}
    for reorder, perm in (("false", False), ("true", True)):
        cfg = arxiv_gcn_config()
        cfg.train.reorder = reorder
        out[reorder] = train_phase(f"phase2 reorder={reorder}", cfg, data, dev, k1_only(3 * n), want_perm=perm)
        ms[reorder] = out[reorder][2]
    log(f"phase2 GCN 3 x 256 median step ms by train.reorder: {json.dumps(ms)}; "
        f"relabelled (auto) / id order (false) {ms['auto'] / ms['false']:.3f}")
    return out


def phase2_gat(data: Data, dev) -> tuple:
    """The GAT main path: full-graph training at arxiv scale. A layer runs
    K3 (numerator) and K2 (denominator) forward; backward K3 (dh), K1 (the
    source gather's VJP) and K2 (the destination gather's VJP); the
    evaluation runs the forward again."""
    cfg = arxiv_gat_config()
    n = cfg.train.epochs * cfg.model.num_layers
    want = {"csr_spmm": n, "segment_sum_csr": 3 * n, "csr_spmm_heads": 3 * n, "blocked_matvec": 0}
    return train_phase("phase2-gat", cfg, data, dev, want, want_perm=True)


def k1_only(count: int) -> dict:
    return {"csr_spmm": count, "segment_sum_csr": 0, "csr_spmm_heads": 0, "blocked_matvec": 0}


def phase2_encoder(data: Data, dev) -> tuple:
    """The flagship EncoderGCN at arxiv scale. K1's input in a mid-block
    conv is dropout(relu(batch_norm(lin(x)))), which always needs a
    gradient, so each of the 2 convs runs K1 forward, backward (dx) and in
    the evaluation: 3 * 2 an epoch. The running statistics that ``fit``
    returns must be finite and moved from their initial (0, 1)."""
    cfg = arxiv_encoder_config()

    def check(model, state, history):
        if state is None or list(state) != [name for name, _ in model.named_buffers()]:
            raise AssertionError(f"phase2-encoder: fit returned buffer state {state}")
        for name, value in state.items():
            initial = torch.zeros_like(value) if name.endswith("running_mean") else torch.ones_like(value)
            if not torch.isfinite(value).all() or torch.equal(value, initial):
                raise AssertionError(f"phase2-encoder: buffer {name} is non-finite or still initial")
        log(f"phase2-encoder buffers: {len(state)} finite, all moved from (0, 1); "
            f"convs.0 running_var mean {state['convs.0.batch_norm.running_var'].mean().item():.4f}")

    want = k1_only(3 * cfg.train.epochs * cfg.model.num_layers)
    return train_phase("phase2-encoder", cfg, data, dev, want, check, want_perm=True)


def first_layer_free(cfg: Config) -> dict:
    """K1's launches where the first layer aggregates the data itself
    (GraphSAGE, GIN): its input needs no gradient, so autograd runs no dx
    there. An epoch runs K1 L times forward, L - 1 times backward and L
    times in the evaluation."""
    L = cfg.model.num_layers
    return k1_only(cfg.train.epochs * (L + (L - 1) + L))


def phase2_sage(data: Data, dev) -> tuple:
    """GraphSAGE 3 x 256 (mean): K1 with the gcn_norm weights at F = 128,
    256, 256, then the division by the edge counts in plain torch."""
    cfg = arxiv_sage_config()
    return train_phase("phase2-sage", cfg, data, dev, first_layer_free(cfg), want_perm=True)


def phase2_gin(data: Data, dev) -> tuple:
    """GIN 3 x 256 under SGD with gradient clipping: K1 with a null weight
    at F = 128, 256, 256."""
    cfg = arxiv_gin_config()
    return train_phase("phase2-gin", cfg, data, dev, first_layer_free(cfg), want_perm=True)


def phase2_sampled_sage(data: Data, dev) -> tuple:
    """This slice's main path at full width: GraphSAGE 3 x 256 (mean) on
    neighbour-sampled minibatches of 1024 seeds with fanouts [15, 10, 5],
    sampler, features, labels and hop adjacencies on the card. A step draws
    the 1,081,344-entry node list, gathers its features and runs K1 with a
    null weight over the three hop CSRs forward and over two transposes (the
    outermost hop's input is gathered data); each full-graph evaluation
    runs K1 three times."""
    cfg = arxiv_sampled_config("sage", SAGE_FANOUTS, steps=20)
    L = cfg.model.num_layers
    return train_phase("phase2-sampled-sage", cfg, data, dev, k1_only(cfg.train.epochs * (L + (L - 1) + L)),
                       falling=True, want_perm=False)


def phase2_sampled_gat(data: Data, dev) -> tuple:
    """The GAT 2 x (8 x 32) on minibatches of 1024 seeds with fanouts [10,
    5]. A hop runs K3 (numerator) and K2 (denominator) forward; backward K3
    (dh; the first hop's too, its input being ``lin``'s output), K1 (the
    source gather's VJP) and K2 (the destination gather's VJP): K1 2, K2 4,
    K3 4 a step. The full-graph evaluation adds K2 2 and K3 2."""
    cfg = arxiv_sampled_config("gat", GAT_FANOUTS, steps=20)
    n = cfg.train.epochs * cfg.model.num_layers
    want = {"csr_spmm": n, "segment_sum_csr": 3 * n, "csr_spmm_heads": 3 * n, "blocked_matvec": 0}
    return train_phase("phase2-sampled-gat", cfg, data, dev, want, falling=True, want_perm=False)


def phase2_host(edges: np.ndarray, dev) -> tuple:
    """``train.host_features`` on a ``Data(host_arrays=True)``: GraphSAGE 2 x
    256 on minibatches of 1024 seeds with fanouts [10, 5], sampled and
    gathered on the host (67,584 rows of 128 features a step), the slab
    copied through pinned memory; nothing graph- or feature-sized on the
    card. Evaluated after steps 5 and 10, neighbour-sampled through the
    same loader in chunks of 1024 ids over the three splits. K1: 2 forward
    and 1 dx a step, 2 a chunk of an evaluation."""
    cfg = arxiv_sampled_config("sage", GAT_FANOUTS, steps=10, host_features=True)
    data = arxiv_scale_data(edges, signal=1.0, host_arrays=True)
    chunks = sum(
        math.ceil(int(mask.sum()) / SAMPLED_BATCH) for mask in (data.train_mask, data.val_mask, data.test_mask)
    )
    evaluations = cfg.train.epochs // cfg.train.eval_every
    L = cfg.model.num_layers

    def check(model, state, history):
        for h in history:
            log(f"phase2-host step_ms={h['step_ms']:.3f} of which on the host: sample + gather "
                f"{h['host_batch_ms']:.3f} ms, staging + copy enqueue {h['host_copy_ms']:.3f} ms; "
                f"neighbour-sampled val_acc={h['val_acc']:.4f} ({chunks} chunks an evaluation)")
        if next(model.parameters()).device.type != "cuda":
            raise AssertionError("phase2-host: the model is not on the card")

    t0 = time.perf_counter()
    out = train_phase("phase2-host", cfg, data, dev,
                      k1_only(cfg.train.epochs * (2 * L - 1) + evaluations * chunks * L), check, falling=True)
    log(f"phase2-host: {cfg.train.epochs} steps and {evaluations} evaluations in {time.perf_counter() - t0:.1f} s")
    return out


def phase2_cluster(data: Data, dev) -> dict:
    """The GCN on the clustered graph through ``fit``, with the same seeds,
    first with ``train.reorder='cluster'``: each blocked product (3 layers x
    forward, dx and evaluation) is one blocked_matvec, which launches K1
    once over its remainder; then with ``'auto'``, K1 over the CSR
    relabelled by degree bucket."""
    n = arxiv_gcn_config().train.epochs * arxiv_gcn_config().model.num_layers
    out = {}
    for reorder, want in (
        ("cluster", {"csr_spmm": 3 * n, "segment_sum_csr": 0, "csr_spmm_heads": 0, "blocked_matvec": 3 * n}),
        ("auto", k1_only(3 * n)),
    ):
        cfg = arxiv_gcn_config()
        cfg.train.reorder = reorder
        out[reorder] = train_phase(f"phase2-cluster reorder={reorder}", cfg, data, dev, want, want_perm=True)
    return out


def pinned_copy_ms(nbytes: int, dev) -> float:
    """Median CUDA-event time of one host-to-device copy of ``nbytes`` from
    pinned memory: the rate the streamed chunks' copies are held to."""
    host = torch.zeros(nbytes // 4, dtype=torch.int32, pin_memory=True)
    card = torch.empty(host.shape, dtype=torch.int32, device=dev)
    return time_ms(lambda: card.copy_(host, non_blocking=True), warmup=2, iters=10)


def stream_norm(ei: np.ndarray, n: int, dev) -> torch.Tensor:
    """d^-1/2 by in-degree over the gcn_norm'ed edges (self loops included):
    the factors whose products are gcn_norm's symmetric weights."""
    deg = np.bincount(ei[1], minlength=n).astype(np.float32)
    return torch.from_numpy(np.where(deg > 0, deg, 1) ** -0.5).to(dev)


def phase2_stream(edges: np.ndarray, dev) -> None:
    """``graphs/streaming.py`` on the card. First the power-law arxiv-scale
    graph at F=128 in chunks of 2^20 edges (3 chunks, destinations cut at
    their boundaries), with baked gcn_norm weights and with ``norm``:
    ``streaming_spmm`` and ``streaming_spmm_grad`` against resident K1
    forward and dx over the same weights, bitwise on a repeat, one K1
    launch a chunk each way. Then, timed, a generated graph whose edge list
    stays on the host (``power_law(2,000,000, 16,000,000)``, undirected,
    gcn_norm self loops: ~34 M edges; halved while its host prep passes 60
    s) against x [N, 128] float32 on the card, in chunks of 2^22 edges:
    chunks, edges/s, the host's pack ms and the copies' and K1's CUDA-event
    ms a chunk, the copies' GB/s beside a pinned copy's measured in this
    run (the stream's bound: its bytes at that rate)."""
    ei, w = gcn_norm(edges, num_nodes=N_NODES, self_loops=True)
    adj = build_adjacency(ei, w, num_nodes=N_NODES).to(dev)
    norm = stream_norm(ei, N_NODES, dev)
    src, dst = adj.src.long(), adj.dst.long()
    norm_w = norm[src] * norm[dst]
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(N_NODES, STREAM_F, generator=gen, device=dev)
    g = torch.randn(N_NODES, STREAM_F, generator=gen, device=dev)
    for mode, stream_w, weight in (("weighted", w, adj.weight), ("norm", None, norm_w)):
        stream = EdgeStream(ei, stream_w, num_nodes=N_NODES, chunk_edges=STREAM_CHUNK)
        t_stream = stream.transpose()
        cut = sum(int(stream.dst[c * STREAM_CHUNK - 1] == stream.dst[c * STREAM_CHUNK])
                  for c in range(1, stream.num_chunks))
        t_weight = weight.index_select(0, adj.t_perm.long())
        n_norm = norm if mode == "norm" else None
        before = csr_spmm.launches
        got = streaming_spmm(stream, x, norm=n_norm)
        torch.cuda.synchronize()
        launched = csr_spmm.launches - before
        err = compare(f"phase2-stream {mode} fwd", got, csr_spmm(adj.row_ptr, adj.src, weight, x), torch.float32)
        if not torch.equal(got, streaming_spmm(stream, x, norm=n_norm)):
            raise AssertionError(f"phase2-stream {mode}: a second pass gave other bits")
        xr = x.clone().requires_grad_()
        before = csr_spmm.launches
        streaming_spmm_grad(stream, t_stream, xr, norm=n_norm).backward(g)
        torch.cuda.synchronize()
        launched_grad = csr_spmm.launches - before
        err_dx = compare(f"phase2-stream {mode} dx", xr.grad, csr_spmm(adj.t_row_ptr, adj.t_col, t_weight, g),
                         torch.float32)
        log(f"phase2-stream arxiv-scale {mode}: {stream.num_edges} edges in {stream.num_chunks} chunks of "
            f"{STREAM_CHUNK} ({cut} destinations cut at a boundary), range_rows {stream.range_rows}; fwd max_abs_err "
            f"{err:.3e}, dx {err_dx:.3e} against resident K1; bitwise on a repeat; K1 launches fwd {launched}, "
            f"fwd + dx {launched_grad}")
        if launched != stream.num_chunks or launched_grad != stream.num_chunks + t_stream.num_chunks:
            raise AssertionError(f"phase2-stream {mode}: K1 launched {launched} / {launched_grad} times, "
                                 f"not once a chunk")
    del adj, x, g, xr, got, norm, norm_w, src, dst
    torch.cuda.empty_cache()

    n, e_dir = STREAM_NODES, STREAM_DIRECTED_EDGES
    while True:
        t0 = time.perf_counter()
        ei, _ = to_undirected(power_law(n, e_dir, alpha=0.8, seed=0), num_nodes=n)
        ei, w = gcn_norm(ei, num_nodes=n, self_loops=True)
        streams = {
            "weighted": EdgeStream(ei, w, num_nodes=n, chunk_edges=STREAM_TIMED_CHUNK),
            "norm": EdgeStream(ei, num_nodes=n, chunk_edges=STREAM_TIMED_CHUNK),
        }
        prep = time.perf_counter() - t0
        if prep <= STREAM_PREP_S:
            break
        log(f"phase2-stream host prep of power_law({n}, {e_dir}) took {prep:.1f} s > {STREAM_PREP_S} s: halving")
        n, e_dir = n // 2, e_dir // 2
    E = streams["norm"].num_edges
    log(f"phase2-stream timed graph: power_law({n}, {e_dir}, alpha=0.8, seed=0), undirected, gcn_norm self loops: "
        f"{n} nodes, {E} edges, edge arrays on the host {(ei.nbytes + w.nbytes) / 1e6:.1f} MB; host prep {prep:.1f} s")
    norm = stream_norm(ei, n, dev)
    del ei, w
    x = torch.randn(n, STREAM_F, generator=gen, device=dev)
    results = {}
    for mode, stream in streams.items():
        n_norm = norm if mode == "norm" else None
        nbytes = stream.packed_len * 4
        pinned_ms = pinned_copy_ms(nbytes, dev)
        streaming_spmm(stream, x, norm=n_norm)  # warm-up
        walls, stats = [], {}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = streaming_spmm(stream, x, norm=n_norm, stats=stats)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if not torch.isfinite(out).all():
            raise AssertionError(f"phase2-stream timed {mode}: non-finite output")
        results[mode] = out
        wall = float(np.median(walls))
        copy_ms, k1_ms = float(np.median(stats["copy_ms"])), float(np.median(stats["k1_ms"]))
        k1_bound = bounds.csr_spmm_bound(stream.range_rows, n, stream.chunk_edges, STREAM_F, 4,
                                         weighted=mode == "weighted")
        bound_ms = stats["h2d_bytes"] / (nbytes / pinned_ms)
        log(f"phase2-stream timed {mode}: chunks {stats['chunks']} of {stream.chunk_edges} edges, range_rows "
            f"{stream.range_rows}, {nbytes / 1e6:.1f} MB a chunk; wall ms a pass {wall * 1e3:.1f} (3 passes: "
            f"{[round(t * 1e3, 1) for t in walls]}), {E / wall / 1e6:.1f} M edges/s; host pack ms a chunk "
            f"{stats['pack_ms'] / stats['chunks']:.2f}; copy ms a chunk {copy_ms:.3f} = {nbytes / copy_ms / 1e6:.2f} "
            f"GB/s against a pinned copy's {pinned_ms:.3f} ms = {nbytes / pinned_ms / 1e6:.2f} GB/s; K1 ms a chunk "
            f"{k1_ms:.3f} (bound {k1_bound.bound_ms:.3f}, no reuse {k1_bound.noreuse_ms:.3f}); the pass's bound "
            f"(its H2D bytes at the pinned rate) {bound_ms:.1f} ms")
    err = compare("phase2-stream timed weighted vs norm", results["weighted"], results["norm"], torch.float32)
    log(f"phase2-stream timed: the weighted and norm passes agree (max abs err {err:.3e})")
    del x, norm, results, out
    torch.cuda.empty_cache()


def card_vs_cpu(label: str, make_model, data: Data, adj_cpu, dev) -> None:
    """Logits, gradients and (after the train-mode forwards) buffers of one
    model on the card against the CPU."""
    model_cpu = make_model(torch.Generator().manual_seed(0))
    model_gpu = make_model(None).to(dev)
    model_gpu.load_state_dict(model_cpu.state_dict())
    adj_gpu = adj_cpu.to(dev)
    for model, adj, d in ((model_cpu, adj_cpu, data), (model_gpu, adj_gpu, data.to(dev))):
        cross_entropy(model(d.x, adj), d.y, d.train_mask).backward()
    compare(f"phase3 small-graph {label} logits (card vs CPU)",
            model_gpu(data.x.to(dev), adj_gpu).cpu(), model_cpu(data.x, adj_cpu), torch.float32)
    for (name, p_gpu), p_cpu in zip(model_gpu.named_parameters(), model_cpu.parameters()):
        if not p_cpu.requires_grad:  # GIN's frozen eps
            continue
        compare(f"phase3 small-graph {label} grad {name}", p_gpu.grad.cpu(), p_cpu.grad, torch.float32)
    buffers = dict(model_cpu.named_buffers())
    for name, b_gpu in model_gpu.named_buffers():
        compare(f"phase3 small-graph {label} buffer {name}", b_gpu.cpu(), buffers[name], torch.float32)
    log(f"phase3 small-graph {label} logits, grads and {len(buffers)} buffers: card matches CPU")


def sampled_card_vs_cpu(label: str, make_model, data: Data, dev, want: tuple) -> None:
    """``forward_sampled`` logits and gradients on the card against the CPU
    for one node list, and the launches (K1, K2, K3) it took."""
    sampler = NeighborSampler(data, [5, 3])
    nodes, adjs_cpu = sampler.sample(torch.Generator().manual_seed(0), torch.arange(64))
    adjs_gpu = sampler.to(dev).adjacencies(64)
    model_cpu = make_model(torch.Generator().manual_seed(0))
    model_gpu = make_model(None).to(dev)
    model_gpu.load_state_dict(model_cpu.state_dict())
    before = (csr_spmm.launches, segment_sum_csr.launches, csr_spmm_heads.launches)
    outs = []
    for model, adjs, device in ((model_cpu, adjs_cpu, "cpu"), (model_gpu, adjs_gpu, dev)):
        out = model.forward_sampled(data.x[nodes].to(device), adjs)
        cross_entropy(out, data.y[:64].to(device)).backward()
        outs.append(out.detach().cpu())
    took = tuple(a - b for a, b in zip((csr_spmm.launches, segment_sum_csr.launches, csr_spmm_heads.launches), before))
    compare(f"phase3 sampled {label} logits (card vs CPU)", outs[1], outs[0], torch.float32)
    for (name, p_gpu), p_cpu in zip(model_gpu.named_parameters(), model_cpu.parameters()):
        if p_cpu.requires_grad:
            compare(f"phase3 sampled {label} grad {name}", p_gpu.grad.cpu(), p_cpu.grad, torch.float32)
    log(f"phase3 sampled {label} forward_sampled logits and grads: card matches CPU; K1, K2, K3 launches {took}")
    if took != want:
        raise AssertionError(f"phase3: sampled {label} launched (K1, K2, K3) {took}, not {want}")


def resume_on_card(label: str, dev, **overrides) -> None:
    """Six epochs in one run against four, a stop, and a resumed run to six
    from the checkpoint: the same losses and accuracies (rtol 1e-6; the
    kernels and the restored generators repeat bit for bit, the library's
    products are not promised to)."""
    data = stochastic_block_model(num_nodes=400, num_classes=4, seed=3)

    def config(epochs, directory=""):
        cfg = Config()
        cfg.model.hidden, cfg.model.dropout = 32, 0.5
        cfg.train.epochs, cfg.train.eval_every = epochs, 1
        cfg.train.checkpoint_dir, cfg.train.checkpoint_every = directory, 2
        return cfg.apply_overrides([f"{k}={v}" for k, v in overrides.items()])

    _, _, whole = fit(config(6), data, device=dev, verbose=False)
    with tempfile.TemporaryDirectory() as directory:
        _, _, head = fit(config(4, directory), data, device=dev, verbose=False)
        _, _, tail = fit(config(6, directory), data, device=dev, resume=True, verbose=False)
    if len(head) != 4 or len(tail) != 2:
        raise AssertionError(f"phase3 resume {label}: {len(head)} + {len(tail)} logged epochs, not 4 + 2")
    for key in ("loss", "train_acc", "val_acc", "test_acc"):
        got, want = [h[key] for h in head + tail], [h[key] for h in whole]
        if not np.allclose(got, want, rtol=1e-6, atol=0.0):
            raise AssertionError(f"phase3 resume {label}: {key} {got} after the resume, {want} uninterrupted")
    same = [h["loss"] for h in head + tail] == [h["loss"] for h in whole]
    log(f"phase3 resume {label}: stop at 4 and resume to 6 equals the uninterrupted run "
        f"({'bit for bit' if same else 'within rtol 1e-6'}); losses {[h['loss'] for h in whole]}")


def kipf_band(dev, reorder: str = "auto") -> None:
    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.dropout = "gcn", 16, 0.5
    cfg.optim.lr, cfg.optim.weight_decay = 0.01, 5e-4
    cfg.train.epochs, cfg.train.eval_every, cfg.train.reorder = 200, 200, reorder
    t0 = time.perf_counter()
    _, _, hist = fit(cfg, cora_like(seed=0), device=dev, verbose=False)
    acc = hist[-1]["test_acc"]
    log(f"phase3 cora_like Kipf GCN train.reorder={reorder}: test_acc={acc:.4f} ({time.perf_counter() - t0:.1f} s)")
    if not 0.78 <= acc <= 0.88:
        raise AssertionError(f"phase3: cora_like test accuracy {acc} (reorder={reorder}) outside [0.78, 0.88]")


def entry_on_card(dev) -> None:
    """``gnn_tpu_torch.entry.entry()``: the flagship GCN forward on the card
    (K1 once a layer) equals its CPU run."""
    from gnn_tpu_torch.entry import entry

    fn, args = entry()
    fn_cpu, args_cpu = entry(device="cpu")
    before = csr_spmm.launches
    with torch.no_grad():
        got = fn(*args)
    took = csr_spmm.launches - before
    with torch.no_grad():
        err = compare("phase3 entry() logits (card vs CPU)", got.cpu(), fn_cpu(*args_cpu), torch.float32)
    log(f"phase3 entry(): flagship GCN forward {tuple(got.shape)} on {got.device}, K1 launches {took}, "
        f"max abs err against the CPU {err:.3e}")
    if took != 2:
        raise AssertionError(f"phase3 entry(): K1 launched {took} times, not 2")


def phase3(dev) -> None:
    """Correctness at small size, the Cora accuracy bands, and the CLI."""
    data = stochastic_block_model(num_nodes=400, num_classes=4, seed=3)
    adj_cpu = data.to_adjacency(norm="sym")
    gcn = lambda gen: GCN(data.num_features, 32, 4, num_layers=3, dropout=0.0, generator=gen)
    card_vs_cpu("GCN", gcn, data, adj_cpu, dev)
    card_vs_cpu("GAT", lambda gen: GAT(data.num_features, 8, 4, heads=4, dropout=0.0, generator=gen),
                data, adj_cpu, dev)
    adj_cluster = data.to_adjacency(norm="sym", reorder="cluster", block_rows=64)
    before = blocked_matvec.launches
    card_vs_cpu("blocked GCN", gcn, data.permute_nodes(adj_cluster.perm), adj_cluster, dev)
    if blocked_matvec.launches - before != 9:  # 3 layers: forward, dx, the checked forward
        raise AssertionError(f"phase3: blocked_matvec launched {blocked_matvec.launches - before} times, not 9")

    F = data.num_features
    before = csr_spmm.launches
    card_vs_cpu("EncoderGCN", lambda gen: EncoderGCN(F, 4, num_layers=2, generator=gen), data, adj_cpu, dev)
    if csr_spmm.launches - before != 6:  # 2 convs: forward, dx, the checked forward
        raise AssertionError(f"phase3: EncoderGCN launched K1 {csr_spmm.launches - before} times, not 6")
    for aggr, want in (("mean", 8), ("max", 0)):  # 3 layers: 3 forward, 2 dx, 3 in the checked forward
        before = csr_spmm.launches
        card_vs_cpu(f"GraphSAGE {aggr}",
                    lambda gen: GraphSAGE(F, 32, 4, num_layers=3, aggr=aggr, dropout=0.0, generator=gen),
                    data, adj_cpu, dev)
        if csr_spmm.launches - before != want:
            raise AssertionError(f"phase3: GraphSAGE {aggr} launched K1 {csr_spmm.launches - before} times, not {want}")
    before = csr_spmm.launches
    card_vs_cpu("GIN", lambda gen: GIN(F, 32, 4, num_layers=3, generator=gen), data, adj_cpu, dev)
    if csr_spmm.launches - before != 8:
        raise AssertionError(f"phase3: GIN launched K1 {csr_spmm.launches - before} times, not 8")

    kipf_band(dev)  # the default train.reorder='auto': cora_like relabelled by degree bucket
    kipf_band(dev, reorder="cluster")

    # The GAT Cora recipe; gnn_tpu.train.fit reaches 0.823 with it on the
    # CPU, and the band is that +- 0.05 (tests/test_torch_gat.py).
    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.heads, cfg.model.dropout = "gat", 8, 8, 0.6
    cfg.optim.lr, cfg.optim.weight_decay = 0.005, 5e-4
    cfg.train.epochs, cfg.train.eval_every = 200, 200
    t0 = time.perf_counter()
    _, _, hist = fit(cfg, cora_like(seed=0), device=dev, verbose=False)
    acc = hist[-1]["test_acc"]
    log(f"phase3 cora_like GAT (train.reorder={cfg.train.reorder}, relabelled): test_acc={acc:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not 0.773 <= acc <= 0.873:
        raise AssertionError(f"phase3: cora_like GAT test accuracy {acc} outside [0.773, 0.873]")

    for flags in (
        ["--model.name", "gcn"], ["--model.name", "gat"], ["--train.reorder", "cluster"],
        ["--train.reorder", "true"], ["--train.reorder", "auto"],
        ["--model.name", "encoder_gcn"], ["--model.name", "sage"], ["--model.name", "gin"],
        ["--optim.name", "sgd", "--optim.grad_clip", "1.0"],
    ):
        rc = cli.main(["--dataset", "sbm", "--device", "cuda", *flags, "--train.epochs", "100"])
        log(f"phase3 cli.main {' '.join(flags)} returned {rc}")
        if rc != 0:
            raise AssertionError(f"phase3: cli.main {' '.join(flags)} returned {rc}")

    # Sampled minibatches at small size: card against CPU, the CLI, resume.
    sampled_card_vs_cpu("GraphSAGE", lambda gen: GraphSAGE(F, 32, 4, dropout=0.0, generator=gen), data, dev, (3, 0, 0))
    sampled_card_vs_cpu("GAT", lambda gen: GAT(F, 8, 4, heads=4, dropout=0.0, generator=gen), data, dev, (2, 4, 4))
    sampled_card_vs_cpu("GIN", lambda gen: GIN(F, 32, 4, num_layers=2, generator=gen), data, dev, (3, 0, 0))
    for name in ("sage", "gat", "gin"):
        flags = ["--model.name", name, "--train.batch_size", "64", "--train.fanouts", "[4,4]"]
        rc = cli.main(["--dataset", "sbm", "--device", "cuda", *flags, "--train.epochs", "100"])
        log(f"phase3 cli.main {' '.join(flags)} returned {rc}")
        if rc != 0:
            raise AssertionError(f"phase3: cli.main {' '.join(flags)} returned {rc}")
    resume_on_card("GCN full graph, dropout 0.5", dev)  # relabelled under the default 'auto'
    entry_on_card(dev)
    resume_on_card("EncoderGCN (buffers)", dev, **{"model.name": "encoder_gcn"})
    resume_on_card("GraphSAGE sampled", dev,
                   **{"model.name": "sage", "train.batch_size": 64, "train.fanouts": "[4,4]"})


def main() -> int:
    phase0()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    edges = arxiv_scale_edges()
    ei, w = gcn_norm(edges, num_nodes=N_NODES, self_loops=True)
    adj = build_adjacency(ei, w, num_nodes=N_NODES).to(dev)
    log(f"graph: {N_NODES} nodes, {adj.num_edges} edges with self loops, "
        f"max in-degree {int((adj.row_ptr[1:] - adj.row_ptr[:-1]).max())}, "
        f"prep {time.perf_counter() - t0:.1f} s")

    checks = {name: {"errs": [], "rows": []} for name in KERNELS}
    by_graph = {"K1": {}, "K3": {}}
    phase1(adj, dev, checks, by_graph)
    phase1_gat(adj, dev, checks, by_graph)
    phase1_unweighted(adj, dev, checks)
    phase1_hop(dev, checks)
    del adj
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    relabelled = build_adjacency(ei, w, num_nodes=N_NODES, reorder=True)
    log(f"relabelled graph (reorder=True, fit's default order): perm present {relabelled.perm is not None}, "
        f"layout {relabelled.layout}, edge_agg present {relabelled.edge_agg is not None}, "
        f"prep {time.perf_counter() - t0:.1f} s")
    relabelled = relabelled.to(dev)
    phase1_relabel(relabelled, dev, checks)
    phase1_edge_agg(relabelled, dev, checks)
    profiling_on_card(relabelled, dev)
    del relabelled
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clustered = clustered_edges()
    log(f"clustered graph: {N_NODES} nodes, {clustered.shape[1]} undirected edges, "
        f"generated in {time.perf_counter() - t0:.1f} s")
    phase1_blocked(clustered, dev, checks, by_graph)
    log_by_graph("K1 F=256 fwd", by_graph["K1"])
    log_by_graph(f"K3 (H,F)={GAT_HEADS[0]} fwd", by_graph["K3"])
    data = arxiv_scale_data(edges)
    runs = {"gcn": phase2(data, dev)}
    runs.update({f"gcn-reorder-{k}": v for k, v in phase2_orders(data, dev, runs["gcn"][2]).items()})
    runs.update({
        "gat": phase2_gat(data, dev), "encoder_gcn": phase2_encoder(data, dev),
        "sage": phase2_sage(data, dev), "gin": phase2_gin(data, dev),
    })
    del data
    sampled = arxiv_scale_data(edges, signal=1.0)
    runs.update({"sage-sampled": phase2_sampled_sage(sampled, dev), "gat-sampled": phase2_sampled_gat(sampled, dev)})
    del sampled
    runs["sage-host"] = phase2_host(edges, dev)
    cluster_runs = phase2_cluster(arxiv_scale_data(clustered), dev)
    runs.update({"gcn-cluster": cluster_runs["cluster"], "gcn-clustered-csr": cluster_runs["auto"]})
    by_path = {path: launches for path, (launches, _, _) in runs.items()}
    phase2_stream(edges, dev)
    phase3(dev)

    # The row each kernel's times come from: its widest main-path shape, on
    # the relabelled graph that fit's default order trains on. ms_id_order is
    # the same call's time in id order, the row these times came from before
    # fit relabelled (None for blocked_matvec, whose graph is always packed).
    main_rows = {
        "csr_spmm": dict(F=256, what="fwd A@x", graph="relabelled"),
        "segment_sum_csr": dict(H=8, what="den [E,8]", graph="relabelled"),
        "csr_spmm_heads": dict(H=8, what="fwd num", graph="relabelled"),
        "blocked_matvec": dict(F=256, what="fwd A@x R=256 float32"),
    }
    entries = []
    for name, meta in KERNELS.items():
        row = next(r for r in checks[name]["rows"] if r["dtype"] == "torch.float32"
                   and all(r.get(k) == v for k, v in main_rows[name].items()))
        shape = {k: v for k, v in main_rows[name].items() if k != "graph"}
        id_row = id_order_row(checks, name, **shape) if "graph" in main_rows[name] else None
        launches = sum(path[name] for path in by_path.values())
        if launches == 0:
            raise AssertionError(f"{name} was not launched on any main path")
        entries.append(dict(
            name=name, route="cuda", **meta,
            launches=launches, max_abs_err=max(checks[name]["errs"]),
            ms=row["ms"], ms_id_order=None if id_row is None else id_row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
            launches_per_step={path: per_step[name] for path, (_, per_step, _) in runs.items()},
        ))
    log(f"launches by path: {json.dumps(by_path)}")
    log(nvidia_smi())
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
