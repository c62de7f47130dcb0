"""One run of one cell: set-up, the checked steps, warm-up, the measured
window, the comparison with the plain reference, and the result line.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell or per-layer metric is
found by name under ``gnnbench/``: ``configs/<config>.json`` (through
``BENCHMARK.json``), ``workloads/<cell>.json``, ``metrics/<metric>.py``,
``reference/<model.name>.py`` and ``flops/<flops>.py``.

The system under test is the port, ``gnn_tpu_torch``, built through its own
entry points (``train.loop.build_model``, ``build_step``,
``build_optimizer``); the window runs ``fit``'s epoch body back to back
(zero_grad, ``TrainStep.loss()``, backward, clipping where configured,
``opt.step()``) without a host sync and without evaluation. The benchmark
makes the inputs: the graph from the cell's fixed seed, the features,
labels, split and initial weights from ``--seed`` on the device. The
program's own random streams (dropout, seed draws, sampler) are seeded with
``--seed`` through its ``train.seed``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gnnbench import graphs
from gnnbench import trace as tr
from gnnbench.reference import common

# Top-level module names that must not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with "gnn_tpu").
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_tpu")
# The program's first steps, which the reference follows.
CHECKED_STEPS = 3


class Refused(Exception):
    """A run that cannot give a result (no card, an unknown cell)."""


def load_module(path: Path):
    """A module of the benchmark found by its file name."""
    if not path.is_file():
        raise Refused(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(f"gnnbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Spec:
    """A cell as the files describe it."""

    root: Path
    bench: dict
    name: str
    entry: dict
    cell: dict
    config: dict

    @property
    def dataset(self) -> dict:
        return self.config["dataset"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def sampled(self) -> bool:
        return self.traffic["mode"] == "sampled"

    def module(self, folder: str, name: str):
        return load_module(self.root / "gnnbench" / folder / f"{name}.py")

    @property
    def reference(self):
        return self.module("reference", self.config["model"]["name"])

    def shapes(self) -> dict:
        ds = self.dataset
        n = ds["num_nodes"]
        out = {"nodes": n, "edges": self.cell_edges + n, "features": ds["num_features"], "classes": ds["num_classes"]}
        if self.sampled:
            hops, n_dst = [], self.traffic["batch_size"]
            for f in self.traffic["fanouts"]:
                hops.append((n_dst, n_dst * (1 + f), n_dst * f))
                n_dst *= 1 + f
            out["hops"] = hops[::-1]
        return out

    cell_edges: int = 0  # undirected edges without self loops, set once the graph is made


def load_spec(root: Path, name: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(f"BENCHMARK.json has no workload '{name}'")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    cell = json.loads((root / "gnnbench" / "workloads" / f"{name}.json").read_text())
    if cell["config"] != entry["config"]:
        raise Refused(f"workloads/{name}.json names config '{cell['config']}', BENCHMARK.json '{entry['config']}'")
    return Spec(root, bench, name, entry, cell, config)


def port_config(spec: Spec, seed: int):
    """The port's ``Config`` of the cell."""
    from gnn_tpu_torch.train.config import Config

    cfg = Config()
    for section in ("model", "optim"):
        for key, value in spec.config[section].items():
            if not hasattr(getattr(cfg, section), key):
                raise Refused(f"the port's config has no {section}.{key}")
            setattr(getattr(cfg, section), key, value)
    t = spec.traffic
    cfg.train.batch_size = t.get("batch_size", 0)
    if spec.sampled:
        cfg.train.fanouts = list(t["fanouts"])
    cfg.train.reorder = t.get("reorder", "auto")
    cfg.train.seed = seed
    return cfg


def initial_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    ds = spec.dataset
    shapes = spec.reference.param_shapes(spec.config["model"], ds["num_features"], ds["num_classes"])
    gen = torch.Generator(device=device).manual_seed(graphs.stream_seed(seed, 1))
    return common.init_params(shapes, gen, device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Program:
    """The training step of the port, built from the seed, and what the
    comparison reads of it."""

    step: Callable[[], torch.Tensor]
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    train_step: object
    device: torch.device
    seconds: Dict[str, float] = field(default_factory=dict)  # set-up by part

    def free(self) -> None:
        self.model = self.opt = self.train_step = self.step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def build_program(spec: Spec, seed: int, edges: np.ndarray, device) -> Program:
    t0 = time.perf_counter()
    from gnn_tpu_torch.graphs.data import Data
    from gnn_tpu_torch.optim import clip_by_global_norm
    from gnn_tpu_torch.train.loop import build_model, build_optimizer, build_step

    device = torch.device(device)
    ds = spec.dataset
    seconds, t0 = {"import": time.perf_counter() - t0}, time.perf_counter()
    cfg = port_config(spec, seed)
    inputs = graphs.node_inputs(ds, seed, device)
    data = Data(x=inputs["x"], edge_index=torch.from_numpy(edges), y=inputs["y"], num_nodes=ds["num_nodes"],
                train_mask=inputs["train_mask"], val_mask=inputs["val_mask"], test_mask=inputs["test_mask"])
    model = build_model(cfg, ds["num_features"], ds["num_classes"], torch.Generator().manual_seed(seed)).to(device)
    model.train()
    weights = initial_weights(spec, seed, device)
    named = dict(model.named_parameters())
    if {k: tuple(v.shape) for k, v in named.items()} != {k: tuple(v.shape) for k, v in weights.items()}:
        raise Refused(f"the port's parameters {sorted(named)} differ from the reference's {sorted(weights)}")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
    sync(device)
    seconds["inputs_and_model"], t0 = time.perf_counter() - t0, time.perf_counter()
    train_step = build_step(cfg, data, model, device)
    sync(device)
    seconds["build_step"], t0 = time.perf_counter() - t0, time.perf_counter()
    params = list(model.parameters())
    opt = build_optimizer(cfg, params)
    clip = cfg.optim.grad_clip
    seconds["optimizer"] = time.perf_counter() - t0

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = train_step.loss()
        loss.backward()
        if clip > 0:
            clip_by_global_norm(params, clip)
        opt.step()
        return loss

    return Program(step, model, opt, train_step, device, seconds)


# ---------------------------------------------------------------- the checked steps


@dataclass
class Readings:
    """What the program produced in its first steps: each step's loss (and
    the first step's logits), dropout keep masks (in call order) and
    sampled node ids, the first gradient as the optimizer holds it, the
    parameters after the last checked step, and the relabelling and edges
    of its graph prep."""

    losses: List[float] = field(default_factory=list)
    first_logits: Optional[torch.Tensor] = None  # the logits the first step's loss is taken of
    masks: List[List[torch.Tensor]] = field(default_factory=list)
    mask_stats: List[List[tuple]] = field(default_factory=list)
    nodes: List[torch.Tensor] = field(default_factory=list)
    first_grads: Dict[str, torch.Tensor] = field(default_factory=dict)
    params: Dict[str, torch.Tensor] = field(default_factory=dict)
    perm: Optional[torch.Tensor] = None
    edges: Optional[torch.Tensor] = None  # [2, E] (src, dst) in the program's ids and edge order
    hops: Optional[list] = None  # [(src, dst, n_dst)] of the sampled hops


class Capture:
    """Observes, for the checked steps only, what the program draws and
    what its loss is taken of: every call of the port's inverted dropout
    (``gnn_tpu_torch.nn.dropout.dropout``) and cross entropy
    (``gnn_tpu_torch.nn.losses.cross_entropy``), under whatever name a module
    of the port holds them, and the sampler's ``NeighborSampler.sample``. A keep mask is read back from the input and
    the output: kept where the output is not 0, or where the input is 0 (any
    mask gives the same there, forward and backward)."""

    def __init__(self):
        self.masks, self.stats, self.nodes, self.logits = [], [], [], []
        self._undo = []

    def __enter__(self):
        from gnn_tpu_torch.graphs.sampling import NeighborSampler

        original = importlib.import_module("gnn_tpu_torch.nn.dropout").dropout
        original_loss = importlib.import_module("gnn_tpu_torch.nn.losses").cross_entropy

        def dropout(x, rate, *, training=True, generator=None):
            out = original(x, rate, training=training, generator=generator)
            if training and 0.0 < rate < 1.0:
                with torch.no_grad():
                    kept = out != 0
                    wrong = (kept & (out != x / (1.0 - rate))).sum()
                    self.stats.append((int(kept.sum()), int((x != 0).sum()), int(wrong)))
                    self.masks.append((kept | (x == 0)).cpu())
            return out

        def cross_entropy(logits, *args, **kwargs):
            self.logits.append(logits.detach().cpu())
            return original_loss(logits, *args, **kwargs)

        wrappers = {id(original): dropout, id(original_loss): cross_entropy}
        for module in list(sys.modules.values()):
            if getattr(module, "__name__", "").split(".")[0] != "gnn_tpu_torch":
                continue
            for attr, value in list(vars(module).items()):
                if id(value) in wrappers:
                    self._undo.append((module, attr, value))
                    setattr(module, attr, wrappers[id(value)])
        sample = NeighborSampler.sample

        def sampled(sampler, generator, seeds):
            nodes, adjs = sample(sampler, generator, seeds)
            self.nodes.append(nodes.cpu())
            return nodes, adjs

        self._undo.append((NeighborSampler, "sample", sample))
        NeighborSampler.sample = sampled
        return self

    def take(self):
        out = (self.masks, self.stats, self.nodes, self.logits)
        self.masks, self.stats, self.nodes, self.logits = [], [], [], []
        return out

    def __exit__(self, *exc):
        for owner, attr, value in reversed(self._undo):
            setattr(owner, attr, value)
        return False


def checked_steps(prog: Program, steps: int = CHECKED_STEPS) -> Readings:
    """The program's first ``steps`` steps through the window's own call,
    with the draws observed."""
    rd = Readings()
    names = {p: n for n, p in prog.model.named_parameters()}
    with Capture() as cap:
        for s in range(steps):
            rd.losses.append(float(prog.step().detach()))
            masks, stats, nodes, logits = cap.take()
            if s == 0 and len(logits) == 1:
                rd.first_logits = logits[0]
            rd.masks.append(masks)
            rd.mask_stats.append(stats)
            if nodes:
                rd.nodes.append(nodes[0])
            if s == 0:  # Adam's state after one step holds (1 - beta1) times the first gradient
                beta1 = prog.opt.param_groups[0]["betas"][0]
                state = prog.opt.state
                rd.first_grads = {  # a leaf the optimizer holds nothing of reads 0
                    n: (state[p]["exp_avg"] / (1 - beta1) if "exp_avg" in state.get(p, {}) else torch.zeros_like(p))
                    .detach().cpu() for p, n in names.items()
                }
    rd.params = {n: p.detach().cpu().clone() for n, p in prog.model.named_parameters()}
    ts = prog.train_step
    if ts.adj is not None:
        rd.edges = torch.stack([ts.adj.src, ts.adj.dst]).long().cpu()
        rd.perm = None if ts.adj.perm is None else ts.adj.perm.long().cpu()
    if ts.hop_adjs:
        rd.hops = [(a.src.long().cpu(), a.dst.long().cpu(), a.num_dst_nodes) for a in ts.hop_adjs]
    return rd


# ---------------------------------------------------------------- the comparison


def _edge_keys(edge_index: torch.Tensor, n: int) -> torch.Tensor:
    return edge_index[1] * n + edge_index[0]


def judge(spec: Spec, seed: int, edges: np.ndarray, rd: Readings):
    """Hold the program's draws and graph prep to what they must be, and
    map its dropout masks into the reference's node and edge order. Returns
    (counts of faults, masks per step for the reference, the sampled hops'
    (src, dst, n_dst) and node ids per step, or None)."""
    n = spec.dataset["num_nodes"]
    rate = spec.config["model"]["dropout"]
    sites = spec.reference.dropout_sites(spec.config["model"], spec.sampled)
    counts = {"dropout_sites_missing": 0, "dropout_scale_errors": 0, "dropout_repeats": 0}
    keep = 1.0 - rate
    sigma = 0.0
    for s, stats in enumerate(rd.mask_stats):
        counts["dropout_sites_missing"] += abs(len(stats) - len(sites))
        for kept, inputs, wrong in stats:
            counts["dropout_scale_errors"] += wrong
            sigma = max(sigma, abs(kept / max(inputs, 1) - keep) / (keep * rate / max(inputs, 1)) ** 0.5)
        if s:
            counts["dropout_repeats"] += sum(
                torch.equal(a, b) for a, b in zip(rd.masks[s], rd.masks[s - 1]) if a.shape == b.shape
            )
    counts["dropout_keep_sigma"] = sigma
    ref_masks, sample = [], None
    if not spec.sampled:
        ref_ei = common.with_self_loops(torch.from_numpy(edges), n)
        ref_keys = _edge_keys(ref_ei, n)
        perm = rd.perm if rd.perm is not None else torch.arange(n)
        counts["relabel_errors"] = int((torch.bincount(perm, minlength=n) != 1).sum()) if len(perm) == n else n
        prog_keys = _edge_keys(perm[rd.edges] if not counts["relabel_errors"] else rd.edges, n)
        pos = torch.searchsorted(ref_keys, prog_keys).clamp_max(len(ref_keys) - 1)
        counts["edge_errors"] = (
            int((ref_keys[pos] != prog_keys).sum())
            + abs(len(prog_keys) - len(ref_keys))
            + len(prog_keys) - len(torch.unique(pos))
        )
        rows = {"node": n, "edge": len(ref_keys)}
        counts["dropout_sites_missing"] += sum(
            m.shape[0] != rows[kind] for masks in rd.masks for kind, m in zip(sites, masks)
        )
        if counts["relabel_errors"] or counts["edge_errors"] or counts["dropout_sites_missing"]:
            return counts, None, None
        if rd.first_logits is not None:
            rd.first_logits = torch.empty_like(rd.first_logits).index_copy_(0, perm, rd.first_logits)
        for masks in rd.masks:
            step = []
            for kind, m in zip(sites, masks):
                out = torch.empty_like(m)
                if kind == "node":
                    out[perm] = m
                else:
                    out[pos] = m
                step.append(out)
            ref_masks.append(step)
        return counts, ref_masks, None
    # sampled: [seeds | their neighbours, row-major | the next hop's | ...]
    t = spec.traffic
    batch, fanouts = t["batch_size"], t["fanouts"]
    keys = torch.from_numpy(edges[1] * n + edges[0])
    deg = torch.from_numpy(np.bincount(edges[1], minlength=n))
    counts.update(seeds_outside_train=0, neighbours_invalid=0, draw_repeats=0, hop_errors=0)
    expected = spec.shapes()["hops"]
    counts["hop_errors"] += abs(len(rd.hops or []) - len(expected))
    counts["dropout_sites_missing"] += sum(
        m.shape[0] != e_edges for masks in rd.masks for m, (_, _, e_edges) in zip(masks, expected)
    )
    for (src, dst, n_dst), (e_dst, e_src, e_edges) in zip(rd.hops or [], expected):
        f = e_edges // e_dst
        counts["hop_errors"] += int(n_dst != e_dst or len(src) != e_edges)
        if len(src) == e_edges:
            counts["hop_errors"] += int((src != e_dst + torch.arange(e_edges)).sum() + (dst != torch.arange(e_edges) // f).sum())
    total = batch
    for f in fanouts:
        total *= 1 + f
    for s, nodes in enumerate(rd.nodes):
        if len(nodes) != total:
            counts["neighbours_invalid"] += total
            continue
        frontier = batch
        for f in fanouts:
            dst = nodes[:frontier].repeat_interleave(f)
            nbr = nodes[frontier : frontier * (1 + f)]
            key = dst * n + nbr
            pos = torch.searchsorted(keys, key).clamp_max(len(keys) - 1)
            ok = (keys[pos] == key) | ((deg[dst] == 0) & (nbr == dst))
            counts["neighbours_invalid"] += int((~ok).sum())
            frontier *= 1 + f
        if s and torch.equal(nodes, rd.nodes[s - 1]):
            counts["draw_repeats"] += 1
    counts["neighbours_invalid"] += abs(len(rd.nodes) - len(rd.losses))
    if counts["hop_errors"] or counts["dropout_sites_missing"] or counts["neighbours_invalid"]:
        return counts, None, None
    hops = [(e_dst + torch.arange(e_edges), torch.arange(e_edges) // (e_edges // e_dst), e_dst)
            for e_dst, _, e_edges in expected]
    return counts, rd.masks, (hops, rd.nodes)


def seeds_outside(spec: Spec, train_mask: torch.Tensor, nodes: List[torch.Tensor]) -> int:
    b = spec.traffic["batch_size"]
    return sum(int((~train_mask[nd[:b].to(train_mask.device)]).sum()) for nd in nodes)


def reference_run(spec: Spec, seed: int, edges: np.ndarray, masks, sample, device, prec=common.REFERENCE,
                  half_batch: bool = False, alter=None) -> dict:
    """The plain reference's first steps from the same inputs and weights,
    with the program's judged draws. ``half_batch`` and ``alter`` plant the
    faults that the limits are held against: the loss over half of the
    batch, and a gradient altered where it is made."""
    device = torch.device(device)
    ref = spec.reference
    model = spec.config["model"]
    ds = spec.dataset
    n = ds["num_nodes"]
    inputs = graphs.node_inputs(ds, seed, device)
    x, y, train_mask = inputs["x"], inputs["y"], inputs["train_mask"]
    if half_batch and not spec.sampled:
        ids = torch.nonzero(train_mask)[:, 0]
        train_mask = train_mask.clone()
        train_mask[ids[len(ids) // 2:]] = False
    params0 = initial_weights(spec, seed, device)
    if spec.sampled:
        hops, nodes = sample
        graph = {"hops": [(src.to(device), dst.to(device), n_dst) for src, dst, n_dst in hops]}
        b = spec.traffic["batch_size"]

        rows = slice(0, b // 2 if half_batch else b)

        def loss_fn(params, s):
            nd = nodes[s].to(device)
            logits = ref.logits(params, model, graph, x[nd], [m.to(device) for m in masks[s]], prec)
            return common.cross_entropy(logits[rows], y[nd[:b]][rows]), logits
    else:
        ei = common.with_self_loops(torch.from_numpy(edges).to(device), n)
        graph = {"edge_index": ei, "weight": common.gcn_weights(ei, n, prec.dtype)}

        def loss_fn(params, s):
            logits = ref.logits(params, model, graph, x, [m.to(device) for m in masks[s]], prec)
            return common.cross_entropy(logits[train_mask], y[train_mask]), logits

    return common.train(loss_fn, params0, spec.config["optim"], CHECKED_STEPS, prec, alter=alter)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    ref_norms = {k: float(ref[k].double().norm()) for k in ref}
    median = statistics.median(ref_norms.values())
    return [abs(float(prog[k].double().cpu().norm()) - ref_norms[k]) / max(ref_norms[k], median) for k in leaves]


def gaps(prog: dict, ref: dict, params0: Dict[str, torch.Tensor]) -> dict:
    """The numbers that can be compared: the first step's logits (the
    widest gap against the reference's largest logit), each step's loss
    (the worst step, and the first step alone), the first gradient and the parameters'
    change over the checked steps (the worst leaf, the median leaf, and all
    leaves as one vector: ``*_total_gap``, against the reference's norm).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (moved by Adam on rounding alone) are left out of the change. A
    cell compares those it gives a limit."""
    g_norms = {k: float(g.double().norm()) for k, g in ref["first_grads"].items()}
    median = statistics.median(g_norms.values())
    moved = [k for k, v in g_norms.items() if v >= 1e-3 * median]
    p0 = {k: v.double().cpu() for k, v in params0.items()}
    change = lambda params: {k: params[k].double().cpu() - p0[k] for k in p0}
    norm = lambda leaves, keys: float(torch.cat([leaves[k].double().flatten().cpu() for k in keys]).norm())
    gap = lambda a, b: abs(a - b) / abs(b)
    losses = [gap(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["first_grads"], ref["first_grads"], list(g_norms))
    moves = leaf_gaps(change(prog["params"]), change(ref["params"]), moved)
    logits_r = ref["first_logits"].double().cpu()
    logits_p = prog["first_logits"]
    logit_gap = (float((logits_p.double().cpu() - logits_r).abs().max() / logits_r.abs().max())
                 if logits_p is not None and logits_p.shape == logits_r.shape else float("inf"))
    return {
        "logit_gap": logit_gap, "loss_gap": max(losses), "first_loss_gap": losses[0],
        "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
        "grad_total_gap": gap(norm(prog["first_grads"], g_norms), norm(ref["first_grads"], g_norms)),
        "change_gap": max(moves), "change_median_gap": statistics.median(moves),
        "change_total_gap": gap(norm(change(prog["params"]), moved), norm(change(ref["params"]), moved)),
    }


def program_side(rd: Readings) -> dict:
    return {"losses": rd.losses, "first_logits": rd.first_logits, "first_grads": rd.first_grads, "params": rd.params}


def compare(spec: Spec, seed: int, edges: np.ndarray, rd: Readings, device, window_nonfinite: int = 0) -> dict:
    """Every number compared, judged draws and gaps to the reference."""
    counts, masks, sample = judge(spec, seed, edges, rd)
    if spec.sampled:
        train_mask = graphs.node_inputs(spec.dataset, seed, device)["train_mask"]
        counts["seeds_outside_train"] = seeds_outside(spec, train_mask, rd.nodes)
    counts["window_loss_nonfinite"] = window_nonfinite
    if masks is None:  # a judged count is over its limit: no reference without sound draws
        return counts
    ref = reference_run(spec, seed, edges, masks, sample, device)
    return {**counts, **gaps(program_side(rd), ref, initial_weights(spec, seed, device))}


def verdict(spec: Spec, numbers: dict) -> tuple:
    """(correct, {name: {value, limit}}): every judged count has the limit
    0, every other number the cell's where the cell gives it one."""
    limits = spec.cell["limits"]
    checks = {k: {"value": v, "limit": limits.get(k, 0)} for k, v in numbers.items()
              if k in limits or isinstance(v, int)}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


# ---------------------------------------------------------------- the window


def window(prog: Program, seconds: float, device) -> dict:
    """Steps back to back for ``seconds`` of the host's clock, from a sync
    before the first to a sync after the last; on the card a CUDA event on
    the stream at each step boundary, read after the window."""
    cuda = prog.device.type == "cuda"
    events, host_marks = [], []
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    steps, loss = 0, None
    while True:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            host_marks.append(time.perf_counter())
        loss = prog.step()
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    sync(device)
    t1 = time.perf_counter()
    if cuda:
        intervals = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        peak = torch.cuda.max_memory_allocated(device)
    else:
        host_marks.append(t1)
        intervals = [(b - a) * 1e3 for a, b in zip(host_marks[:-1], host_marks[1:])]
        peak = 0
    return {
        "t0": t0, "steps": steps, "step_ms": (t1 - t0) * 1e3 / steps,
        "step_p95_ms": float(np.percentile(intervals, 95)), "peak_bytes": peak,
        "nonfinite": int(not torch.isfinite(loss).item()),
    }


def launch_counters() -> Dict[str, int]:
    """Every launch counter of the port: a function of ``gnn_tpu_torch``
    with an integer ``launches`` attribute (``csr_spmm.launches``, ...)."""
    out = {}
    for name, module in list(sys.modules.items()):
        if name.split(".")[0] != "gnn_tpu_torch":
            continue
        for value in list(vars(module).values()):
            count = getattr(value, "launches", None)
            if callable(value) and isinstance(count, int):
                out[value.__name__] = count
    return out


@dataclass
class Traced:
    """What the per-layer readers read: the cell, its shapes, the traced
    steps' events, their host window and device-busy time, and the
    port's launch counters over them (per step)."""

    spec: Spec
    shapes: dict
    steps: int
    window_s: float
    events: list
    kernels: list
    busy_s: float
    counters: Dict[str, float]

    @property
    def flops(self):
        return self.spec.module("flops", self.spec.config["flops"])


def traced_steps(prog: Program, spec: Spec, device) -> Traced:
    """``trace_steps`` steady steps under ``torch.profiler``, after one that
    starts the profiler, each end synchronised."""
    from torch.profiler import ProfilerActivity, profile, schedule

    steps = spec.cell["trace_steps"]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if prog.device.type == "cuda" else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
        prog.step()
        sync(device)
        prof.step()
        t0, c0 = time.perf_counter(), launch_counters()
        for i in range(steps):
            prog.step()
            if i == steps - 1:
                sync(device)
                t1, c1 = time.perf_counter(), launch_counters()
            prof.step()
    events = list(prof.events())
    kernels = tr.device_kernels(events)
    busy = tr.union_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e6
    counters = {k: (c1[k] - c0.get(k, 0)) / steps for k in c1}
    return Traced(spec, spec.shapes(), steps, t1 - t0, events, kernels, busy, counters)


def breakdown(t: Traced) -> dict:
    """The ten device operations that took most time, and the idle time
    between device operations by what the host was doing (the innermost
    host event around the middle of each of the 200 longest gaps), in
    seconds over the traced steps."""
    by_name: Dict[str, float] = {}
    for e in t.kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + tr.duration_us(e) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted((e.time_range.start, e.time_range.end) for e in t.kernels)
    gaps, cur_end = [], None
    for start, end in spans:
        if cur_end is not None and start > cur_end:
            gaps.append((start - cur_end, (start + cur_end) / 2))
        cur_end = end if cur_end is None else max(cur_end, end)
    gaps = sorted(gaps, reverse=True)[:200]
    host = [e for e in t.events if not tr.on_device(e)]
    idle: Dict[str, float] = {}
    if host and gaps:
        starts = np.array([e.time_range.start for e in host])
        ends = np.array([e.time_range.end for e in host])
        for length, mid in gaps:
            around = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = host[around[np.argmin(ends[around] - starts[around])]].name if len(around) else "(no host event)"
            idle[name] = idle.get(name, 0.0) + length / 1e6
    return {"device_ops": [list(kv) for kv in ops],
            "idle_gaps": [list(kv) for kv in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def reader(spec: Spec, name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, and for
    ``<name>.<kind>`` (the twin that moves ``step_ms.<kind>``) the reader of
    ``<name>`` where it has none of its own."""
    path = spec.root / "gnnbench" / "metrics" / f"{name}.py"
    return load_module(path if path.is_file() else path.with_name(f"{name.split('.')[0]}.py"))


def per_layer(t: Traced) -> dict:
    """Each per-layer metric of BENCHMARK.json that this cell reports, from
    its :func:`reader`; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    reported = {m["name"] for m in t.spec.bench["end_to_end"] if t.spec.name in m.get("workloads", [t.spec.name])}
    for m in t.spec.bench["per_layer"]:
        if t.spec.name not in m.get("workloads", [t.spec.name]) or m["moves"] not in reported:
            continue
        value = reader(t.spec, m["name"]).read(t)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(spec: Spec, w: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics; ``<name>.<kind>`` is ``<name>`` for
    the cells of one kind (``step_ms.sampled``)."""
    values = {"step_ms": w["step_ms"], "step_p95_ms": w["step_p95_ms"],
              "peak_mem_gib": w["peak_bytes"] / 2**30, "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
            for m in spec.bench["end_to_end"] if spec.name in m.get("workloads", [spec.name])}


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(argv, t_start: float, root: Path, device: Optional[str] = None) -> int:
    """One run; prints the result line and returns 0, or raises
    :class:`Refused`. ``device`` None is the card, which must be there;
    tests pass ``'cpu'`` to drive the rest of a run."""
    args = parse(argv)
    if args.seed < 0:
        raise Refused("--seed must be a whole number >= 0")
    spec = load_spec(root, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < spec.entry["chips"]:
            raise Refused(f"the cell needs {spec.entry['chips']} cards, {torch.cuda.device_count()} are visible")
        device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    torch.empty(1, device=dev)
    sync(dev)
    marks.append(("device", time.perf_counter()))
    edges = graphs.edges(spec.dataset, spec.traffic["graph"])
    spec.cell_edges = edges.shape[1]
    marks.append(("graph", time.perf_counter()))
    prog = build_program(spec, args.seed, edges, dev)
    sync(dev)
    marks.append(("program", time.perf_counter()))
    rd = checked_steps(prog)
    marks.append(("checked_steps", time.perf_counter()))
    for _ in range(spec.cell["warmup_steps"]):
        prog.step()
    sync(dev)
    marks.append(("warmup", time.perf_counter()))
    log("setup_s by phase: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
        + " (program: " + ", ".join(f"{k} {v:.3f}" for k, v in prog.seconds.items()) + ")")
    t = None
    if args.trace:
        t = traced_steps(prog, spec, dev)
    w = window(prog, args.seconds, dev)
    if t is not None:
        w["steps"] += t.steps
    setup_s = w["t0"] - t_start
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": spec.entry["chips"],
        "memory_peak_bytes": w["peak_bytes"],
    }
    if t is not None:
        metrics = per_layer(t)
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        extra = {"breakdown": breakdown(t)}
        t = None
    else:
        metrics, extra = end_to_end(spec, w, setup_s), {}
    prog.free()
    numbers = compare(spec, args.seed, edges, rd, dev, window_nonfinite=w["nonfinite"])
    correct, checks = verdict(spec, numbers)
    bad = forbidden_modules()
    if bad:
        raise Refused(f"the run loaded {', '.join(bad)}")
    result = {"correct": correct, "attempted": w["steps"], "failed": w["nonfinite"], "metrics": metrics,
              "device": device_info, **extra, "checks": checks}
    for name, value in numbers.items():
        if name not in checks:
            log(f"not compared {name} {value!r}")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv, t_start: float, root: Path) -> int:
    try:
        return run(argv, t_start, root)
    except Refused as e:
        log(f"gnnbench: {e}")
        return 2
