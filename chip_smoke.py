"""Smoke run of the PyTorch / CUDA port (``gnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 builds the hand-written kernels from ``gnn_tpu_torch/csrc`` with
nvcc and prints the card, its power limit and the build time. Phase 1 holds
each kernel against its plain PyTorch version on an ogbn-arxiv-scale graph
(power law, 169,343 nodes, about 2.5 M normalized edges with self loops) at
F in {40, 128, 256}, float32 and bfloat16, and times both with CUDA events:
the GCN of phase 2 runs K1 at F = 256 and 40, and 128 is its input width.
Phase 2 trains the port's full-graph GCN (3 layers, hidden 256, 40 classes)
for 5 epochs on that graph through ``gnn_tpu_torch.train.fit`` and checks
that it launched the SpMM kernel. Phase 3 checks the kernel path against the
CPU path on a small graph, trains the Kipf GCN recipe on ``cora_like`` into
Cora's accuracy band, and runs the CLI.

The next-to-last line of standard output is a JSON object with each
kernel's launches, error and times; the last is
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no result. It needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from gnn_tpu_torch.graphs import Data, build_adjacency, gcn_norm, power_law, to_undirected
from gnn_tpu_torch.graphs.generate import cora_like, stochastic_block_model
from gnn_tpu_torch.models import GCN
from gnn_tpu_torch.nn import cross_entropy
from gnn_tpu_torch.ops import spmm, spmm_edge_weighted
from gnn_tpu_torch.ops.cuda import _build
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr, segment_sum_csr_plain
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain, spmm_csr
from gnn_tpu_torch.train import Config, fit
from gnn_tpu_torch.train import cli

N_NODES = 169_343  # ogbn-arxiv
E_DIRECTED = 1_157_799
IN_FEATURES, NUM_CLASSES = 128, 40
WIDTHS = (40, 128, 256)
# float32: hub rows sum thousands of terms in another order than the plain
# version's atomics. bfloat16: the plain version sums the same bf16 inputs
# in float32 and rounds once, so the two differ by at most one bf16 rounding
# of the output (relative 2^-8), plus the float32 order error near zero.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
KERNELS = {
    "csr_spmm": dict(
        source="gnn_tpu_torch/csrc/csr_spmm.cu",
        replaces="gnn_tpu/ops/pallas/spmm.py:102",
    ),
    "segment_sum_csr": dict(
        source="gnn_tpu_torch/csrc/segment_sum.cu",
        replaces="gnn_tpu/ops/pallas/segment.py:192",
    ),
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
    return info


def phase1(adj, dev) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {name: {"errs": [], "rows": []} for name in KERNELS}
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

            t = {
                "fwd": (time_ms(lambda: csr_spmm(adj.row_ptr, adj.src, adj.weight, x)),
                        time_ms(lambda: csr_spmm_plain(adj.row_ptr, adj.src, adj.weight, x))),
                "dx": (time_ms(lambda: csr_spmm(adj.t_row_ptr, adj.t_col, adj.t_weight, g)),
                       time_ms(lambda: csr_spmm_plain(adj.t_row_ptr, adj.t_col, adj.t_weight, g))),
                "seg": (time_ms(lambda: segment_sum_csr(adj.row_ptr, msg)),
                        time_ms(lambda: segment_sum_csr_plain(adj.row_ptr, msg))),
            }
            for name, what, err, key in (
                ("csr_spmm", "fwd A@x", e_fwd, "fwd"),
                ("csr_spmm", "bwd dx=A^T g", e_bwd, "dx"),
                ("segment_sum_csr", "[E,F] -> [N,F]", e_seg, "seg"),
            ):
                ms, plain_ms = t[key]
                results[name]["rows"].append(dict(F=F, dtype=str(dtype), what=what, err=err, ms=ms, plain_ms=plain_ms))
                if dtype == torch.float32:
                    results[name]["errs"].append(err)
                log(f"phase1 {name:16s} {what:15s} {tag:14s} max_abs_err={err:.3e} "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")

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
    return results


def arxiv_scale_data(edges: np.ndarray) -> Data:
    """Seeded 128-dim features, 40 classes and a 54/18/28 % split (the
    proportions of ogbn-arxiv) on the arxiv-scale graph."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_NODES, IN_FEATURES)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, N_NODES)
    perm = rng.permutation(N_NODES)
    n_train, n_val = int(0.54 * N_NODES), int(0.18 * N_NODES)
    masks = {k: np.zeros(N_NODES, bool) for k in ("train", "val", "test")}
    masks["train"][perm[:n_train]] = True
    masks["val"][perm[n_train : n_train + n_val]] = True
    masks["test"][perm[n_train + n_val :]] = True
    return Data(
        x=x, edge_index=edges, y=y, num_nodes=N_NODES,
        train_mask=masks["train"], val_mask=masks["val"], test_mask=masks["test"],
    )


def arxiv_gcn_config(epochs: int = 5) -> Config:
    """GCN 3 x 256, dropout 0.5, Adam lr 0.01: the OGB GCN baseline for arxiv."""
    cfg = Config()
    cfg.model.name, cfg.model.num_layers, cfg.model.hidden, cfg.model.dropout = "gcn", 3, 256, 0.5
    cfg.optim.name, cfg.optim.lr = "adam", 0.01
    cfg.train.epochs, cfg.train.eval_every = epochs, 1
    return cfg


def phase2(edges: np.ndarray, dev) -> dict:
    """The port's main path: full-graph GCN training at arxiv scale."""
    data = arxiv_scale_data(edges)
    cfg = arxiv_gcn_config()

    csr_spmm.launches = 0
    segment_sum_csr.launches = 0
    _, _, history = fit(cfg, data, device=dev, verbose=False)
    launches = {"csr_spmm": csr_spmm.launches, "segment_sum_csr": segment_sum_csr.launches}

    losses = [h["loss"] for h in history]
    step_ms = [h["step_ms"] for h in history]
    log(f"phase2 losses per epoch: {losses}")
    log(f"phase2 step ms per epoch (synced): {step_ms}")
    log(f"phase2 median ms/epoch over epochs 2-5: {float(np.median(step_ms[1:])):.3f}")
    log(f"phase2 launches: {launches}")
    if len(losses) != cfg.train.epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"phase2: expected {cfg.train.epochs} finite losses, got {losses}")
    want = cfg.train.epochs * (cfg.model.num_layers + cfg.model.num_layers - 1)
    if launches["csr_spmm"] < want:
        raise AssertionError(f"phase2: csr_spmm launched {launches['csr_spmm']} times, expected >= {want}")
    return launches


def phase3(dev) -> None:
    """Correctness at small size, the Cora accuracy band, and the CLI."""
    data = stochastic_block_model(num_nodes=400, num_classes=4, seed=3)
    adj_cpu = data.to_adjacency(norm="sym")
    adj_gpu = adj_cpu.to(dev)
    model_cpu = GCN(data.num_features, 32, 4, num_layers=3, dropout=0.0,
                    generator=torch.Generator().manual_seed(0))
    model_gpu = GCN(data.num_features, 32, 4, num_layers=3, dropout=0.0).to(dev)
    model_gpu.load_state_dict(model_cpu.state_dict())
    for model, adj, d in ((model_cpu, adj_cpu, data), (model_gpu, adj_gpu, data.to(dev))):
        cross_entropy(model(d.x, adj), d.y, d.train_mask).backward()
    compare("phase3 small-graph logits (card vs CPU)",
            model_gpu(data.x.to(dev), adj_gpu).cpu(), model_cpu(data.x, adj_cpu), torch.float32)
    for (name, p_gpu), p_cpu in zip(model_gpu.named_parameters(), model_cpu.parameters()):
        compare(f"phase3 small-graph grad {name}", p_gpu.grad.cpu(), p_cpu.grad, torch.float32)
    log("phase3 small-graph logits and grads: card matches CPU")

    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.dropout = "gcn", 16, 0.5
    cfg.optim.lr, cfg.optim.weight_decay = 0.01, 5e-4
    cfg.train.epochs, cfg.train.eval_every = 200, 200
    t0 = time.perf_counter()
    _, _, hist = fit(cfg, cora_like(seed=0), device=dev, verbose=False)
    acc = hist[-1]["test_acc"]
    log(f"phase3 cora_like Kipf GCN: test_acc={acc:.4f} ({time.perf_counter() - t0:.1f} s)")
    if not 0.78 <= acc <= 0.88:
        raise AssertionError(f"phase3: cora_like test accuracy {acc} outside [0.78, 0.88]")

    rc = cli.main(["--dataset", "sbm", "--device", "cuda", "--train.epochs", "100"])
    log(f"phase3 cli.main returned {rc}")
    if rc != 0:
        raise AssertionError(f"phase3: cli.main returned {rc}")


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

    checks = phase1(adj, dev)
    del adj
    torch.cuda.empty_cache()
    launches = phase2(edges, dev)
    phase3(dev)

    entries = []
    for name, meta in KERNELS.items():
        main_row = next(r for r in checks[name]["rows"] if r["F"] == 256 and r["dtype"] == "torch.float32")
        entries.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[name], max_abs_err=max(checks[name]["errs"]),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        ))
    on_path = [e for e in entries if e["launches"] > 0]
    off_path = [e for e in entries if e["launches"] == 0]
    log(nvidia_smi())
    log(json.dumps({"kernels": on_path, "checked_off_path": off_path}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
