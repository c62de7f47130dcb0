"""Training loops: full graph and sampled minibatches.

Port of the single-device branches of ``gnn_tpu/train/loop.py::fit``:

* **full graph**: one-time prep (exact ``gcn_norm`` and the CSR adjacency,
  moved to the device; under the default ``train.reorder='auto'`` and under
  ``'true'`` the nodes of a degree-symmetric graph are relabelled by degree
  bucket, under ``'cluster'`` by community into packed windows, as in the
  JAX ``fit``, and every relabelling aggregates on the same CSR; features,
  labels and masks move with them), then per epoch the model
  -> masked cross entropy -> backward -> (gradient clipping ->) Adam, AdamW
  or SGD;
* **sampled minibatches** (``train.batch_size > 0``; ``sage``, ``gat``,
  ``gin``): an "epoch" is one batch of seeds drawn with replacement from the
  training nodes by ``np.random.default_rng(train.seed)``, as in the JAX
  ``fit``; the :class:`~gnn_tpu_torch.graphs.sampling.NeighborSampler`, the
  features, the labels and the constant hop adjacencies live on the device,
  and the step is sample -> ``x[nodes]`` -> ``forward_sampled`` -> loss on
  the seeds. The evaluation stays the full-graph one;
* **host features** (``train.host_features`` with a batch size; for graphs
  whose features exceed the device's memory, e.g. a
  ``Data(host_arrays=True)`` over memmaps): nothing graph- or feature-sized
  moves to the device. :class:`~gnn_tpu_torch.train.host_loader.HostBatchLoader`
  samples and gathers on the host, the [batch_nodes, F] slab goes over
  through pinned memory, and the evaluation is neighbour-sampled through the
  same loader, in chunks of the batch size.

All of them share evaluation every ``eval_every`` epochs, metrics, early
stopping on validation accuracy and checkpoints
(``train.checkpoint_dir``, ``fit(resume=True)``). It trains every
``model.name`` of the config: ``gcn``, ``gat`` (ignores the edge weights),
``gatv2`` (likewise; the full graph on one device only),
``encoder_gcn`` (BatchNorm buffers: updated by the train step, read by the
evaluation, returned in the middle slot), ``sage`` (scales its messages by
the ``gcn_norm`` weights, as the JAX ``fit`` hands them to every model) and
``gin`` (drops them).

With ``dist.num_parts = P > 1`` (``gnn_tpu/train/loop.py:135-324``):

* **full graph, partitioned**: the graph goes into P parts on ``device``
  (``Data.to_dist_graph``, halo ``dist.halo``; ``dist.cluster_order`` or
  ``dist.local_blocked`` relabel the nodes by community first, the latter
  into windows of that many nodes, to which it aligns the parts, and
  ``local_blocked`` forces halo 'overlap', warning where another was asked
  for), features, labels and masks into its padded layout (masks ``False``
  on the padding rows, so that the loss and the accuracies leave them out;
  without a ``train_mask`` the loss takes every real node, where the JAX
  ``fit`` would average over the padding rows too),
  and the model runs on the ``DistGraph`` (``parallel/``). A model with
  buffers (BatchNorm) must take a ``mask`` keyword, which leaves the padding
  rows out of its statistics; the evaluation runs on the padded layout;
* **data-parallel sampled minibatches** (with ``train.batch_size``): each of
  the P parts samples ``batch_size / P`` of the step's seeds with its own
  generator, and the loss is the mean of the parts' losses.

Without a process group, one process holds every part, on ``device``. In a
``torch.distributed`` group of W processes
(:func:`gnn_tpu_torch.parallel.multihost.initialize`; a group of one
included) each process holds ``P / W`` of them on its own ``device``, the
counterpart of the JAX ``fit`` over a mesh that spans hosts, and the step's
sums over the graph ride the group (the mesh's ``data_group``): the masked
loss and the accuracies divide by the group's count of the mask (each
process's loss is its share, ``nn.losses``), BatchNorm's masked statistics
are the group's (``BatchNorm.process_group``, set for the run), the
gradients are summed over the group after ``backward`` (one coalesced
all-reduce, before clipping), so parameters and optimizer state stay equal
bit for bit on every process; the logged loss and accuracies are the
group's, and early stopping decides on them. A data-parallel sampled step
keeps each global part's generator (``train.seed + 2 + p``) and its loss is
the mean over all P parts. Dropout draws from one stream a process (rank
0's is the one-process stream), so with dropout on, a group's masks differ
from one process's; without, its run equals one process's up to the order
of float32 sums (bit for bit in a group of one). Rank 0 writes the
checkpoints (with every process's random streams) and logs; every process
restores them. A group of W > 1 processes needs ``dist.num_parts`` to be a
multiple of W: ``fit`` refuses to run there without parts, where each
process would train the whole graph as rank 0.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.graphs.blocked import cluster_order
from gnn_tpu_torch.graphs.convert import as_numpy
from gnn_tpu_torch.graphs.data import Data
from gnn_tpu_torch.graphs.sampling import NeighborSampler
from gnn_tpu_torch.models import GAT, GCN, GIN, EncoderGCN, GATv2, GraphSAGE
from gnn_tpu_torch.nn.losses import accuracy, cross_entropy
from gnn_tpu_torch.nn.normalization import BatchNorm
from gnn_tpu_torch.nn.state import buffer_state
from gnn_tpu_torch.optim import SGD, Adam, AdamW, clip_by_global_norm
from gnn_tpu_torch.parallel import Mesh, make_mesh, multihost
from gnn_tpu_torch.train.checkpoint import Checkpointer
from gnn_tpu_torch.train.config import Config
from gnn_tpu_torch.train.host_loader import HostBatchLoader
from gnn_tpu_torch.train.metrics import MetricLogger, Throughput
from gnn_tpu_torch.utils.tracing import span

__all__ = ["build_model", "build_optimizer", "build_step", "TrainStep", "fit", "evaluate"]

_SPLITS = ("train", "val", "test")
# train.reorder -> build_adjacency(reorder=...), as gnn_tpu/train/loop.py:239-244
_REORDER = {"auto": "auto", "true": True, "false": False, "cluster": "cluster"}


def build_model(
    cfg: Config, in_features: int, num_classes: int, generator: Optional[torch.Generator] = None
) -> nn.Module:
    m = cfg.model
    if m.name == "gcn":
        return GCN(
            in_features, m.hidden, num_classes,
            num_layers=m.num_layers, dropout=m.dropout, generator=generator,
        )
    if m.name == "gat":
        return GAT(
            in_features, m.hidden, num_classes,
            num_layers=m.num_layers, heads=m.heads, dropout=m.dropout, generator=generator,
        )
    if m.name == "gatv2":
        return GATv2(
            in_features, m.hidden, num_classes,
            num_layers=m.num_layers, heads=m.heads, dropout=m.dropout, generator=generator,
        )
    if m.name == "sage":
        return GraphSAGE(
            in_features, m.hidden, num_classes,
            num_layers=m.num_layers, aggr=m.aggr, dropout=m.dropout, generator=generator,
        )
    if m.name == "gin":
        return GIN(in_features, m.hidden, num_classes, num_layers=m.num_layers, generator=generator)
    if m.name == "encoder_gcn":
        return EncoderGCN(
            in_features, num_classes, num_layers=m.num_layers, dropout=m.dropout, generator=generator
        )
    raise ValueError(f"unknown model '{m.name}'")


def build_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.optim.name``. ``optim.grad_clip`` is not part
    of it: ``fit`` clips the gradients before each step."""
    o = cfg.optim
    if o.name == "adam":
        return Adam(params, lr=o.lr, weight_decay=o.weight_decay)
    if o.name == "adamw":
        return AdamW(params, lr=o.lr, weight_decay=o.weight_decay)
    if o.name == "sgd":
        return SGD(params, lr=o.lr, momentum=o.momentum, weight_decay=o.weight_decay)
    raise ValueError(f"unknown optimizer '{o.name}'")


def _check_supported(cfg: Config) -> None:
    """The JAX ``fit``'s own guards, with its errors, and the port's own."""
    t = cfg.train
    dp_sampled = cfg.dist.num_parts > 1 and t.batch_size > 0
    if dp_sampled and t.batch_size % cfg.dist.num_parts:
        raise ValueError(
            f"train.batch_size={t.batch_size} must divide evenly over "
            f"dist.num_parts={cfg.dist.num_parts} chips"
        )
    if t.host_features and not t.batch_size:
        raise ValueError("train.host_features requires batch_size > 0")
    if t.host_features and dp_sampled:
        raise ValueError(
            "train.host_features is the single-process host-gather path; it does not "
            "combine with dist.num_parts"
        )
    world = multihost.process_count()
    if world > 1 and cfg.dist.num_parts < world:
        # each process would train the whole graph as rank 0, and all of
        # them would write the same log and checkpoints
        raise ValueError(
            f"fit in a torch.distributed group of {world} processes spreads the graph's parts over them: "
            f"set dist.num_parts (--dist.num_parts) to a multiple of {world}, got {cfg.dist.num_parts}"
        )
    if cfg.dist.num_parts > 1 and cfg.dist.num_parts % world:
        raise ValueError(
            f"dist.num_parts={cfg.dist.num_parts} must divide evenly over the {world} processes of the group"
        )
    if str(t.reorder).lower() not in _REORDER:
        raise ValueError(f"unknown train.reorder '{t.reorder}'")


def _split_masks(data: Data) -> dict:
    return {split: getattr(data, f"{split}_mask") for split in _SPLITS}


@torch.no_grad()
def evaluate(model: nn.Module, data: Data, adj: Adjacency, group=None) -> dict:
    """Accuracy per split, in inference mode (dropout off, BatchNorm on its
    running statistics). ``group``: the process group over which the rows
    are spread; the accuracies are then the group's."""
    was_training = model.training
    model.eval()
    logits = model(data.x, adj)
    model.train(was_training)
    splits = [s for s in _SPLITS if getattr(data, f"{s}_mask") is not None]
    if not splits:
        return {}
    accs = torch.stack([accuracy(logits, data.y, getattr(data, f"{s}_mask"), group=group) for s in splits])
    if group is not None:
        tdist.all_reduce(accs, group=group)  # the shares sum to the group's accuracies
    return {f"{s}_acc": float(a) for s, a in zip(splits, accs.tolist())}


class _HostFeed:
    """Moves one [batch_nodes, F] slab a step from the loader's numpy to the
    device through one pinned staging buffer, without waiting for the copy
    (``non_blocking``). An event guards the buffer: the next slab is staged
    only after the last copy has left it. On the CPU the slab is used as it
    is. ``batch_ms`` and ``copy_ms`` hold the host clock's time of the last
    sample + gather and of the last staging + enqueue."""

    def __init__(self, loader: HostBatchLoader, device: torch.device):
        self.loader, self.device = loader, device
        self._stage = self._copied = None
        self.batch_ms = self.copy_ms = 0.0

    def __call__(self, seeds: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        t0 = time.perf_counter()
        feats, ys = self.loader.batch(seeds)
        t1 = time.perf_counter()
        feats, ys = torch.from_numpy(np.ascontiguousarray(feats)), torch.from_numpy(ys.astype(np.int64))
        if self.device.type == "cuda":
            if self._stage is None or self._stage.shape != feats.shape or self._stage.dtype != feats.dtype:
                self._stage = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
                self._copied = torch.cuda.Event()
            self._copied.synchronize()
            self._stage.copy_(feats)
            feats = self._stage.to(self.device, non_blocking=True)
            self._copied.record()
            ys = ys.to(self.device)
        self.batch_ms, self.copy_ms = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
        return feats, ys


@torch.no_grad()
def host_evaluate(model: nn.Module, feed: _HostFeed, adjs, masks: dict, batch_size: int) -> dict:
    """Neighbour-sampled accuracy per split (the usual large-graph
    approximation of inference), from minibatches of the training loader: no
    device-resident x or adjacency at any point. Chunks of ``batch_size``
    ids, the last one padded with node 0 and cut after the forward."""
    was_training = model.training
    model.eval()
    out = {}
    for split in _SPLITS:
        mask = masks.get(split)
        if mask is None:
            continue
        ids = np.nonzero(as_numpy(mask))[0]
        if not len(ids):
            continue
        correct = 0
        for lo in range(0, len(ids), batch_size):
            chunk = ids[lo : lo + batch_size]
            n = len(chunk)
            padded = np.concatenate([chunk, np.zeros(batch_size - n, np.int64)])
            feats, ys = feed(padded)
            logits = model.forward_sampled(feats, adjs)
            correct += int((logits[:n].argmax(-1) == ys[:n]).sum())
        out[f"{split}_acc"] = correct / len(ids)
    model.train(was_training)
    return out


def _random_state(dropout_gen, sample_gens, rng_np, loader) -> dict:
    """What a resumed run needs beyond parameters, optimizer and buffers to
    continue bit for bit: every random stream's position."""
    state = {
        "dropout_generator": dropout_gen.get_state(),
        "seed_rng": json.dumps(rng_np.bit_generator.state),
        "sampler_generators": [g.get_state() for g in sample_gens],
    }
    if loader is not None:
        state["host_loader_seed"] = loader._seed
    return state


def _restore_random_state(state: dict, dropout_gen, sample_gens, rng_np, loader) -> None:
    dropout_gen.set_state(state["dropout_generator"])
    rng_np.bit_generator.state = json.loads(state["seed_rng"])
    for gen, saved in zip(sample_gens, state["sampler_generators"]):
        gen.set_state(saved)
    if loader is not None:
        loader._seed = int(state["host_loader_seed"])


@dataclass
class TrainStep:
    """One configuration's training step, as ``fit`` runs it (:meth:`step`):
    ``loss()`` draws what the step draws (seeds, neighbours, dropout) and
    returns the step's loss, ready for ``backward``. The rest is what the step reads:
    ``data`` and ``adj`` as they lie on the device (``adj`` None with
    ``train.host_features``, whose ``data`` stays where it was; a partitioned
    step's ``adj`` is its ``DistGraph`` and ``data`` its padded layout), the
    hop adjacencies of a sampled step, the host feed, the random streams
    (a sampler generator a part of this process: one without
    ``dist.num_parts``), and the mesh of ``dist.num_parts`` (None without).
    In a process group ``loss()`` is this process's share of the step's loss
    (the shares sum over ``group`` to it) and ``data`` holds its rows."""

    loss: Callable[[], torch.Tensor]
    data: Data
    adj: Optional[Adjacency]
    hop_adjs: Optional[list]
    feed: Optional[_HostFeed]
    dropout_gen: torch.Generator
    sample_gens: list
    rng_np: np.random.Generator
    mesh: Optional[Mesh] = None

    @property
    def group(self):
        """The process group the step's sums ride (the mesh's data group),
        None in one process."""
        return self.mesh.data_group if self.mesh is not None and self.mesh.grouped else None

    def step(self, opt: torch.optim.Optimizer, params: list, clip: float = 0.0) -> torch.Tensor:
        """One training step of ``params`` by ``opt``, as ``fit`` runs it:
        the gradients cleared, :attr:`loss`, its backward, the gradients
        summed over the :attr:`group` (before clipping: it reads the
        group's gradients), clipped to a global norm of ``clip`` where
        ``clip > 0``, and the optimizer's step. Returns the loss."""
        opt.zero_grad(set_to_none=True)
        loss = self.loss()
        loss.backward()
        if self.group is not None:
            multihost.all_reduce_gradients(params, self.group)
        if clip > 0:
            clip_by_global_norm(params, clip)
        opt.step()
        return loss


def _check_mask_kwarg(model: nn.Module) -> None:
    """A model with buffers (BatchNorm running statistics) trains on the
    padded layout only if its forward takes the validity ``mask``."""
    if not any(True for _ in model.buffers()):
        return
    params = inspect.signature(model.forward).parameters
    if "mask" in params or any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return
    raise ValueError(
        f"{type(model).__name__} carries buffer state (BatchNorm running stats) but its forward "
        "accepts no 'mask' kwarg: batch statistics over the padded distributed node layout would "
        "fold padding rows in. Add mask support (see nn.BatchNorm / models.EncoderGCN) or train "
        "on one device."
    )


def _partitioned(cfg: Config, data: Data, model: nn.Module, mesh: Mesh):
    """The full graph in ``dist.num_parts`` parts over ``mesh``: (this
    process's padded ``Data``, the ``DistGraph``, the model's extra
    keywords, the loss's mask)."""
    _check_mask_kwarg(model)
    d, device = cfg.dist, mesh.device
    halo, blocks = d.halo, int(d.local_blocked)
    if blocks and halo != "overlap":
        # local_blocked needs the local/remote edge split of 'overlap'; the
        # default 'alltoall' moves silently, another choice with a warning
        if halo != "alltoall":
            warnings.warn(
                f"dist.local_blocked={blocks} requires halo='overlap'; overriding dist.halo='{halo}'",
                stacklevel=3,
            )
        halo = "overlap"
    if d.cluster_order or blocks:
        # community-contiguous ids: the node ranges cut between communities
        # (exact: GNNs are permutation-equivariant)
        data = data.permute_nodes(cluster_order(as_numpy(data.edge_index), data.num_nodes, pack_rows=blocks))
    graph = data.to_dist_graph(mesh=mesh, halo=halo, axis_name=d.axis_name, local_blocked=blocks)
    pad = lambda a, fill=0: None if a is None else graph.shard_nodes(a.to(device), fill=fill)
    valid = pad(torch.ones(data.num_nodes, dtype=torch.bool), False)
    masks = {f"{s}_mask": pad(getattr(data, f"{s}_mask"), False) for s in _SPLITS}
    padded = Data(x=pad(data.x), y=pad(data.y), num_nodes=graph.num_local_parts * graph.n_max, **masks)
    # without a train_mask the loss takes every real node, none of the padding
    loss_mask = valid if padded.train_mask is None else padded.train_mask
    return padded, graph, {"mask": valid} if any(True for _ in model.buffers()) else {}, loss_mask


def build_step(cfg: Config, data: Data, model: nn.Module, device: torch.device) -> TrainStep:
    """The training step of ``cfg`` for ``model`` (already on ``device``)
    over ``data``: the one-time prep of ``fit`` (adjacency or partition,
    sampler or host loader, moved to the device or left on the host) and the
    step's loss. A sampled step marks its sampling and its gather with the
    spans ``sampled.sample`` and ``sampled.gather``."""
    t = cfg.train
    sampled = t.batch_size > 0
    n_parts = max(cfg.dist.num_parts, 1)
    adj = sampler = feed = hop_adjs = mesh = None
    sample_gens, kwargs, loss_mask = [], {}, None
    if n_parts > 1 and not t.host_features:
        # P parts over the group's processes (all of them in this one
        # without a group), each process's on its device
        mesh = make_mesh((n_parts,), (cfg.dist.axis_name,),
                         devices=[device] * (n_parts // multihost.process_count()))
    group = mesh.data_group if mesh is not None and mesh.grouped else None
    rank = mesh.process_index if mesh is not None else 0
    local_parts = range(mesh.first_part, mesh.first_part + mesh.num_local_parts) if mesh is not None else range(1)
    if sampled:
        if data.train_mask is None:
            raise ValueError("train.batch_size > 0 draws its seeds from data.train_mask, which is None")
        train_ids = np.nonzero(as_numpy(data.train_mask))[0]
    if t.host_features:
        # Nothing graph- or feature-sized moves to the device: the loader
        # reads data's arrays where they are (memmaps included).
        loader = HostBatchLoader(
            as_numpy(data.edge_index), as_numpy(data.x), as_numpy(data.y), t.fanouts,
            num_nodes=data.num_nodes, seed=t.seed,
        )
        feed = _HostFeed(loader, device)
        hop_adjs = [a.to(device) for a in loader.adjacencies(t.batch_size)]
    elif n_parts > 1 and not sampled:
        data, adj, kwargs, loss_mask = _partitioned(cfg, data, model, mesh)
        for module in model.modules():
            if isinstance(module, BatchNorm):
                module.process_group = group  # the statistics over every process's rows
    else:
        # train.reorder: relabel the nodes by degree bucket or into
        # community-packed windows (exact: GNNs are permutation-equivariant;
        # features, labels and masks move with the nodes). Sampled
        # minibatches index data.x by the original ids: no relabelling.
        reorder = False if sampled else _REORDER[str(t.reorder).lower()]
        adj = data.to_adjacency(norm="sym", reorder=reorder)
        if adj.perm is not None:
            data = data.permute_nodes(adj.perm)
        adj = adj.to(device)
        data = data.to(device)
        if sampled:
            # data-parallel: a generator and batch_size / P seeds a part
            sampler = NeighborSampler(data, t.fanouts).to(device)
            sample_gens = [torch.Generator(device=device).manual_seed(t.seed + 2 + p) for p in local_parts]
            hop_adjs = sampler.adjacencies(t.batch_size // n_parts)
    # one dropout stream a process (rank 0's that of one process)
    seed = t.seed + 1 if rank == 0 else int(np.random.SeedSequence([t.seed + 1, rank]).generate_state(1)[0])
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    rng_np = np.random.default_rng(t.seed)  # the same seeds on every process

    def sampled_loss(gen: torch.Generator, seeds: np.ndarray) -> torch.Tensor:
        with span("sampled.sample"):
            seeds = torch.from_numpy(seeds).to(device)
            nodes, adjs = sampler.sample(gen, seeds)
        with span("sampled.gather"):
            feats, ys = data.x.index_select(0, nodes), data.y.index_select(0, seeds)
        return cross_entropy(model.forward_sampled(feats, adjs, generator=dropout_gen), ys)

    def loss() -> torch.Tensor:
        if not sampled:
            mask = data.train_mask if loss_mask is None else loss_mask
            return cross_entropy(model(data.x, adj, generator=dropout_gen, **kwargs), data.y, mask, group=group)
        seeds = rng_np.choice(train_ids, t.batch_size)
        if feed is not None:
            feats, ys = feed(seeds)
            return cross_entropy(model.forward_sampled(feats, hop_adjs, generator=dropout_gen), ys)
        if n_parts == 1:
            return sampled_loss(sample_gens[0], seeds)
        parts = np.split(seeds, n_parts)[local_parts.start : local_parts.stop]
        losses = torch.stack([sampled_loss(gen, part) for gen, part in zip(sample_gens, parts)])
        return losses.mean() if group is None else losses.sum() / n_parts  # a share of the P parts' mean

    return TrainStep(loss, data, adj, hop_adjs, feed, dropout_gen, sample_gens, rng_np, mesh)


def fit(
    cfg: Config,
    data: Data,
    *,
    model: Optional[nn.Module] = None,
    device="cuda",
    resume: bool = False,
    verbose: bool = True,
) -> Tuple[nn.Module, Optional[Dict[str, torch.Tensor]], list]:
    """Train per config on ``device``. Returns (trained model, buffer state,
    history); the buffer state is ``buffer_state(model)`` for a model with
    buffers (EncoderGCN's running statistics) and None otherwise.

    With ``train.checkpoint_dir`` a checkpoint is written after every
    ``train.checkpoint_every``-th epoch that is also evaluated, and at the
    end. ``resume=True`` restores the latest one (parameters, optimizer
    state, buffers) and continues after its epoch. The port also saves and
    restores the position of every random stream (dropout, sampler, seed
    draw, the host loader's seed), so a resumed run continues an interrupted
    one exactly; the JAX ``fit`` re-makes its streams from the seed. Early
    stopping's best-so-far is not carried across a resume, as there.

    Early stopping restores the best epoch's *parameters* only, as the JAX
    ``fit`` does: the buffers stay those of the last epoch run.

    Each history entry holds the split accuracies, ``loss`` (of the epoch's
    step), ``edges_per_s`` since the start, and ``step_ms``: the wall time
    from the start of the epoch's step (a sampled step's seed draw,
    sampling and gather included) to its loss on the host (a sync). With
    ``train.host_features`` also ``host_batch_ms`` (the step's sample +
    gather on the host) and ``host_copy_ms`` (staging the slab in pinned
    memory and enqueueing its copy).
    """
    _check_supported(cfg)
    t = cfg.train
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda') needs a CUDA device; none is available")
    if model is None:
        model = build_model(
            cfg, data.num_features, int(data.y.max()) + 1,
            torch.Generator().manual_seed(t.seed),
        )
    sampled = t.batch_size > 0
    if sampled and not hasattr(model, "forward_sampled"):
        raise ValueError(
            f"train.batch_size > 0 needs a model with forward_sampled (sage, gat, gin); "
            f"{type(model).__name__} has none"
        )
    model = model.to(device)
    model.train()
    masks, num_edges = _split_masks(data), data.num_edges
    train_step = build_step(cfg, data, model, device)
    data, adj, feed, hop_adjs = train_step.data, train_step.adj, train_step.feed, train_step.hop_adjs
    loader = feed.loader if feed is not None else None
    dropout_gen, sample_gens, rng_np = train_step.dropout_gen, train_step.sample_gens, train_step.rng_np
    group, mesh = train_step.group, train_step.mesh
    rank, world = (mesh.process_index, mesh.process_count) if group is not None else (0, 1)
    params = list(model.parameters())
    opt = build_optimizer(cfg, params)
    logger = MetricLogger(t.log_file if rank == 0 else "", echo=verbose and rank == 0)

    ckpt, start_epoch = None, 0
    if t.checkpoint_dir:
        ckpt = Checkpointer(t.checkpoint_dir)
        if resume and ckpt.latest_step() is not None:
            _, _, _, extra = ckpt.restore(model, opt, buffer_state(model) or None)
            if extra and ("random_state" in extra or "random_states" in extra):
                # a run in a group keeps every process's streams, in rank order
                states = extra.get("random_states") or [extra["random_state"]]
                if len(states) != world:
                    raise ValueError(
                        f"the checkpoint holds the random streams of {len(states)} processes; this run has {world}"
                    )
                _restore_random_state(states[rank], dropout_gen, sample_gens, rng_np, loader)
            start_epoch = int(ckpt.latest_step())

    def save_checkpoint(step: int) -> None:
        state = _random_state(dropout_gen, sample_gens, rng_np, loader)
        if group is None:
            ckpt.save(step, model, opt, buffer_state(model) or None, {"random_state": state})
            return
        states = [None] * world
        with torch.cuda.device(mesh.device) if mesh.device.type == "cuda" else contextlib.nullcontext():
            tdist.all_gather_object(states, state)  # on NCCL through the current card
        if rank == 0:  # parameters, optimizer state and buffers are the same on every process
            ckpt.save(step, model, opt, buffer_state(model) or None, {"random_states": states})
        multihost.barrier(mesh.device)  # no process reads the directory before rank 0 has written it

    history = []
    best_val, best_state, patience_left = -1.0, None, t.patience
    thr = Throughput(num_edges)
    thr.start()
    for epoch in range(start_epoch, t.epochs):
        t_step = time.perf_counter()
        loss = train_step.step(opt, params, cfg.optim.grad_clip)
        thr.step()
        if (epoch + 1) % t.eval_every == 0 or epoch == t.epochs - 1:
            if group is not None:
                loss = loss.detach().clone()
                tdist.all_reduce(loss, group=group)  # the shares sum to the group's loss
            loss_value = loss.item()  # syncs the device
            step_ms = (time.perf_counter() - t_step) * 1e3
            edges_per_s = thr.edges_per_s
            if feed is not None:
                host_ms = dict(host_batch_ms=feed.batch_ms, host_copy_ms=feed.copy_ms)
                metrics = host_evaluate(model, feed, hop_adjs, masks, t.batch_size)
                metrics.update(host_ms)
            else:
                metrics = evaluate(model, data, adj, group)
            metrics.update(loss=loss_value, edges_per_s=edges_per_s, step_ms=step_ms)
            logger.log(epoch + 1, **metrics)
            history.append(metrics)
            if ckpt and t.checkpoint_every and (epoch + 1) % t.checkpoint_every == 0:
                save_checkpoint(epoch + 1)
            val = metrics.get("val_acc")
            if t.patience and val is not None:
                if val > best_val:
                    best_val, patience_left = val, t.patience
                    best_state = {k: p.detach().clone() for k, p in model.named_parameters()}
                else:
                    patience_left -= 1
                    if patience_left <= 0:
                        break

    if best_state is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(best_state[name])
    if ckpt:
        save_checkpoint(t.epochs)
        ckpt.close()
    logger.close()
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.process_group = None  # set by build_step for this run's group
    return model, buffer_state(model) or None, history
