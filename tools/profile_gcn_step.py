"""Where a training step's time goes on one NVIDIA GPU, for any of the models.

    python3 tools/profile_gcn_step.py [--model gcn|gat|encoder_gcn|sage|gin] [--graph powerlaw|clustered]
        [--reorder auto|true|false|cluster] [--batch-size B --fanouts 15,10,5 [--host-features]]
        [--parts P [--halo allgather|alltoall|overlap]] [--warmup 5] [--timed 10] [--steps 5] [--trace PATH]

Builds the arxiv-scale graph of ``chip_smoke.py`` (``--graph powerlaw``, the
default, phases 2 and 2-gat; ``--graph clustered``, phase 2-cluster) and the
model of phase 2 (``--model gcn``, the default: GCN 3 x 256, 40 classes,
dropout 0.5, Adam lr 0.01) or phase 2-gat (``--model gat``: GAT 2 layers, 8
heads x 32, 1 output head, dropout 0.5, Adam lr 0.005), 2-encoder
(``--model encoder_gcn``: the flagship, pre-MLP 128 -> 256 -> 128, 2
mid-block convs, post-MLP; Adam), 2-sage (``--model sage``: GraphSAGE 3 x
256, mean; Adam) or 2-gin (``--model gin``: GIN 3 x 256; SGD with momentum
and gradient clipping); ``--reorder`` is ``fit``'s ``train.reorder``:
``auto`` (the default) and ``true`` relabel the nodes by degree bucket,
``false`` keeps the ids, ``cluster`` relabels them and builds the
cluster-blocked layout. It runs ``fit``'s training step on it:
the model with dropout -> masked cross entropy, backward, (clipping,) the
optimizer. ``--batch-size B --fanouts f1,f2,...`` (``--model sage`` or
``gat``; one layer per fanout) runs ``fit``'s neighbour-sampled step instead
(both steps come from ``gnn_tpu_torch.train.loop.build_step``, as ``fit``'s do),
as in ``chip_smoke.py``'s phases 2-sampled-*: seeds drawn on the host, the
node list sampled on the card, ``x[nodes]`` gathered, ``forward_sampled``,
the loss on the seeds; with ``--host-features`` the sampling and the gather
run on the host and one pinned slab a step is copied over (phase 2-host).
``--parts P`` sets ``dist.num_parts``: the full graph in P parts on the card
(``--halo``; phase 2-dist), with ``--batch-size`` the data-parallel sampled
step; the busy time is then also split by the ``halo.exchange`` range.
After
``--warmup`` steps it times ``--timed`` untraced steps with CUDA events,
then traces ``--steps`` steps with ``torch.profiler``. It prints:

- ms per step, untraced and traced (CUDA events around the steps);
- device-busy ms per step: the union of the intervals of every device
  activity (kernels, copies, memsets) in the trace, so nothing is counted
  twice;
- the idle share, 1 - busy / traced window, and 1 - busy / untraced step
  (the profiler slows the host, so a launch-bound step's traced window is
  longer than its untraced step);
- device ms, launches and share of busy time per kernel name;
- the busy time split into K1, K2, K3 (by the Op in their names), Linear
  (the library's matrix products, by ``gemm`` and its kin in theirs) and
  the rest;
- with ``--reorder cluster``, the busy time split into the block product
  (the kernels inside ``blocked_matvec``'s ``blocked_matvec.diag`` range:
  pad, bmm, cast), the kernels and the rest;
- with ``--model gat``, the busy time split into the SDDMM ``d ex`` (the
  kernels inside ``_SpmmHeads.backward``'s ``spmm_heads.dw`` range, itemized
  as gathers, multiply and reduce), the kernels and the rest, and K3's time
  beside its bound from ``gnn_tpu_torch.ops.cuda.bounds``;
- with ``--batch-size``, the busy time split into the sampler (the kernels
  inside the step's ``sampled.sample`` range), the ``x[nodes]`` gather
  (``sampled.gather``), the kernels and the rest, the hops' K1 bound, and
  with ``--host-features`` the host's ms per step for sample + gather and
  for staging + enqueueing the copy (``layer split:`` then has a row for the
  copies).

The hand-written kernels are told apart by the instance of
``gnn::csr_reduce_kernel<T, vec, lanes, Op>`` / ``gnn::csr_reduce_fixup<T, vec,
Op>`` in their names: ``gnn::Gather`` K1, ``gnn::Contiguous`` K2,
``gnn::GatherHeads`` K3.

``--trace`` also writes a Chrome trace to PATH. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    N_NODES, arxiv_encoder_config, arxiv_gat_config, arxiv_gcn_config, arxiv_gin_config, arxiv_sage_config,
    arxiv_sampled_config, arxiv_scale_data, arxiv_scale_edges, clustered_edges, log, nvidia_smi,
)
from gnn_tpu_torch.ops.cuda import bounds  # noqa: E402
from gnn_tpu_torch.optim import clip_by_global_norm  # noqa: E402
from gnn_tpu_torch.train.loop import build_model, build_optimizer, build_step  # noqa: E402

DEVICE_TYPES = (DeviceType.CUDA,)
CONFIGS = {
    "gcn": arxiv_gcn_config, "gat": arxiv_gat_config, "encoder_gcn": arxiv_encoder_config,
    "sage": arxiv_sage_config, "gin": arxiv_gin_config,
}
# Substrings of the names of the library's matrix-product kernels (nn.Linear
# forward, dW and dX; under --reorder cluster the block product too).
GEMM_NAMES = ("gemm", "cutlass", "xmma", "cublas", "gemv")


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


# The Op in a kernel's name -> the port's kernel.
KERNEL_OPS = (("gnn::GatherHeads", "K3 csr_reduce_* GatherHeads"), ("gnn::Gather", "K1 csr_reduce_* Gather"),
              ("gnn::Contiguous", "K2 csr_reduce_* Contiguous"))
# Substrings of the names of PyTorch's kernels inside the SDDMM range.
SDDMM_PARTS = (("gather", "gathers"), ("index", "gathers"), ("reduce", "reduce"))


def split_by_range(prof_events, kernels, steps: int, inside: dict) -> dict:
    """Device ms and launches per step of the kernels inside the annotation
    ranges on the device that ``inside`` names (keyed by ``inside[range
    name](kernel name)``), of K1, K2, K3 and of the rest. Empty where the
    trace holds no such range."""
    ranges = [
        (e.time_range.start, e.time_range.end, e.name) for e in prof_events
        if e.device_type in DEVICE_TYPES and getattr(e, "is_user_annotation", False)
        and e.name in inside
    ]
    if not ranges:
        return {}
    out = defaultdict(lambda: [0.0, 0.0])
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        held_by = next((name for lo, hi, name in ranges if lo <= start and end <= hi), None)
        if held_by is not None:
            key = inside[held_by](e.name)
        else:
            key = next((label for op, label in KERNEL_OPS if op in e.name), "rest")
        out[key][0] += (end - start) / 1e3 / steps
        out[key][1] += 1 / steps
    return dict(out)


def layer_of(name: str) -> str:
    """K1, K2 or K3 by the Op in a kernel's name, Linear for a matrix
    product, else the rest."""
    label = next((label for op, label in KERNEL_OPS if op in name), None)
    if label is None and any(sub in name.lower() for sub in GEMM_NAMES):
        label = "Linear (matrix products)"
    if label is None and "memcpy" in name.lower():
        label = "copies (Memcpy)"
    return label or "rest"


def sddmm_part(name: str) -> str:
    part = next((label for sub, label in SDDMM_PARTS if sub in name.lower()), "multiply")
    return f"SDDMM d ex: {part}"


def timed_ms(step, n: int) -> float:
    """Device-timeline ms per step over ``n`` steps, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=tuple(CONFIGS), default="gcn")
    ap.add_argument("--graph", choices=("powerlaw", "clustered"), default="powerlaw")
    ap.add_argument("--reorder", choices=("auto", "true", "false", "cluster"), default="auto")
    ap.add_argument("--batch-size", type=int, default=0, help="seeds of a neighbour-sampled minibatch; 0 = full graph")
    ap.add_argument("--fanouts", default="15,10,5", help="with --batch-size: one fanout per layer, outermost last")
    ap.add_argument("--host-features", action="store_true", help="with --batch-size: sample and gather on the host")
    ap.add_argument("--parts", type=int, default=0, help="dist.num_parts: the graph (or the batch) in P parts on the card")
    ap.add_argument("--halo", choices=("allgather", "alltoall", "overlap"), default="alltoall", help="with --parts")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--timed", type=int, default=10)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    sampled = args.batch_size > 0
    if sampled and (args.model not in ("sage", "gat") or args.reorder != "auto"):
        ap.error("--batch-size goes with --model sage or gat and --reorder auto")
    if args.host_features and not sampled:
        ap.error("--host-features needs --batch-size")
    if not torch.cuda.is_available():
        raise SystemExit("profile_gcn_step.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    log(nvidia_smi())
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}")

    edges = arxiv_scale_edges() if args.graph == "powerlaw" else clustered_edges()
    data = arxiv_scale_data(edges, signal=1.0 if sampled else 0.0, host_arrays=args.host_features)
    cfg = CONFIGS[args.model]()
    if sampled:
        fanouts = [int(f) for f in args.fanouts.split(",")]
        cfg = arxiv_sampled_config(args.model, fanouts, 1, args.host_features)
        cfg.train.batch_size = args.batch_size
    cfg.train.reorder = args.reorder
    cfg.dist.num_parts, cfg.dist.halo = args.parts, args.halo
    model = build_model(
        cfg, data.num_features, int(data.y.max()) + 1,
        torch.Generator().manual_seed(cfg.train.seed),
    ).to(dev)
    model.train()
    params = list(model.parameters())
    opt = build_optimizer(cfg, params)
    train_step = build_step(cfg, data, model, dev)
    adj, hop_adjs, feed = train_step.adj, train_step.hop_adjs, train_step.feed
    n_edges = data.num_edges if adj is None or args.parts > 1 else adj.num_edges  # adj's: with self loops
    log(f"graph: {args.graph}, {N_NODES} nodes, {n_edges} edges; model {args.model}; reorder {args.reorder}"
        + (f"; batch {args.batch_size}, fanouts {cfg.train.fanouts}" if sampled else "")
        + ("; host features" if args.host_features else "")
        + (f"; {args.parts} parts, halo {args.halo}" if args.parts > 1 else ""))
    host_ms = {"batch": [], "copy": []}

    def step():
        opt.zero_grad(set_to_none=True)
        loss = train_step.loss()
        loss.backward()
        if feed is not None:
            host_ms["batch"].append(feed.batch_ms)
            host_ms["copy"].append(feed.copy_ms)
        if cfg.optim.grad_clip > 0:
            clip_by_global_norm(params, cfg.optim.grad_clip)
        opt.step()

    for _ in range(args.warmup):
        step()
    untraced = timed_ms(step, args.timed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = timed_ms(step, args.steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # User annotations (e.g. "Optimizer.step#Adam.step") span the gaps between
    # the kernels they cover, so only real device activity counts.
    events = prof.events()
    device_events = [
        e for e in events
        if e.device_type in DEVICE_TYPES and not getattr(e, "is_user_annotation", False)
    ]
    if not device_events:
        raise SystemExit("the trace holds no device activity; time with CUDA events only")
    busy = union_us((e.time_range.start, e.time_range.end) for e in device_events) / 1e3 / args.steps
    per_name = defaultdict(lambda: [0.0, 0])
    for e in device_events:
        per_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3 / args.steps
        per_name[e.name][1] += 1
    log(f"ms per step: untraced {untraced:.3f} (mean of {args.timed}), "
        f"traced {traced:.3f} (mean of {args.steps})")
    log(f"device busy per step: {busy:.3f} ms; idle share {1 - busy / traced:.4f} "
        f"(of the untraced step: {1 - busy / untraced:.4f}; the two differ where the step is bound by the "
        f"host's launches, which the profiler slows)")
    log(f"{'device ms/step':>14s} {'launches/step':>13s} {'share':>6s}  kernel")
    for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0]):
        log(f"{ms:14.3f} {count / args.steps:13.1f} {ms / busy:6.1%}  {name[:100]}")
    by_layer = defaultdict(lambda: [0.0, 0])
    for e in device_events:
        entry = by_layer[layer_of(e.name)]
        entry[0] += (e.time_range.end - e.time_range.start) / 1e3 / args.steps
        entry[1] += 1
    for key, (ms, count) in sorted(by_layer.items(), key=lambda kv: -kv[1][0]):
        log(f"layer split: {key}: {ms:.3f} ms/step in {count / args.steps:.1f} launches ({ms / busy:.1%} of busy)")
    splits = []
    if args.reorder == "cluster":
        splits.append(("blocked", {"blocked_matvec.diag": lambda name: "block product (pad, bmm, cast)"}))
    if args.model == "gat":
        splits.append(("gat", {"spmm_heads.dw": sddmm_part}))
    if args.parts > 1 and not sampled:
        splits.append(("halo", {"halo.exchange": lambda name: "halo exchange (gather on the card)"}))
    if sampled and not args.host_features:
        splits.append(("sampled", {"sampled.sample": lambda name: "sampler (draws, index ops)",
                                   "sampled.gather": lambda name: "x[nodes], y[seeds] gather"}))
    for label, inside in splits:
        split = split_by_range(events, device_events, args.steps, inside)
        if not split:
            log(f"{label} split: not measured (the trace holds no device-side {' / '.join(inside)} range)")
        for key, (ms, count) in sorted(split.items()):
            log(f"{label} split: {key}: {ms:.3f} ms/step in {count:.1f} launches ({ms / busy:.1%} of busy)")
    if sampled:
        log("hop CSRs (destinations, edges, sources): "
            + ", ".join(f"({a.num_dst_nodes}, {a.num_edges}, {a.num_src_nodes})" for a in hop_adjs))
    if sampled and args.model == "sage":
        widths = [data.num_features] + [cfg.model.hidden] * (len(hop_adjs) - 1)
        k1 = []
        for i, (a, width) in enumerate(zip(hop_adjs, widths)):
            k1.append(bounds.csr_spmm_bound(a.num_dst_nodes, a.num_src_nodes, a.num_edges, width, 4, weighted=False))
            if i > 0:  # no dx over the outermost hop: its input is gathered data
                k1.append(
                    bounds.csr_spmm_bound(a.num_src_nodes, a.num_dst_nodes, a.num_edges, width, 4, weighted=False))
        log(f"K1 bound of a training step's {len(k1)} launches over the hops: "
            f"{sum(b.bound_ms for b in k1):.3f} ms (no reuse {sum(b.noreuse_ms for b in k1):.3f} ms)")
    if args.host_features:
        tail = slice(-(args.timed + args.steps), None)
        log(f"host ms per step (mean over the timed and traced steps): sample + gather "
            f"{np.mean(host_ms['batch'][tail]):.3f}, staging + copy enqueue {np.mean(host_ms['copy'][tail]):.3f}")
    if args.model == "gat" and not sampled and args.parts <= 1:
        n, e, size = adj.num_dst_nodes, adj.num_edges, 4
        k3 = [bounds.csr_spmm_heads_bound(n, n, e, cfg.model.heads, cfg.model.hidden, size, indexed=t)
              for t in (False, True)]
        k3 += [bounds.csr_spmm_heads_bound(n, n, e, 1, int(data.y.max()) + 1, size, indexed=t) for t in (False, True)]
        log(f"K3 bound of a training step's 4 launches: {sum(b.bound_ms for b in k3):.3f} ms "
            f"(no reuse {sum(b.noreuse_ms for b in k3):.3f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
