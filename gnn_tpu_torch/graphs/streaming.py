"""Host-streamed edge chunks: aggregation over graphs whose edges stay on the host.

Port of ``gnn_tpu/graphs/streaming.py``. The edge list stays on the host
(numpy, or ``np.memmap`` for graphs larger than memory), sorted by
destination once and cut into chunks of ``chunk_edges`` edges; the features
``x`` and the output lie on the device (:func:`streaming_spmm`), or, with
:class:`DistEdgeStream`, x stays on the host too and each chunk ships the
unique source rows it reads, part by part of a node partition. A chunk
touches one contiguous destination range ``[d_lo, d_lo + range_rows)``.

:class:`EdgeStream` is the JAX class with the same constructor, checks and
host arrays (``chunks``, ``chunks_rle``, ``chunks_packed``). Each chunk ships
as one packed int32 buffer ``[src (C) | counts (R + 1) | weight bits (C,
if weighted)]``, the destinations run-length encoded.

:func:`streaming_spmm` reduces a chunk with **one launch of kernel K1**
(``ops/cuda/spmm.py``): the run-length counts *are* the chunk's CSR offsets,
``row_ptr = [0, cumsum(counts[:R])]``, so the chunk's gather, scale and
reduce is K1 over ``(row_ptr, src, w)`` into an [R, F] partial, which is
added into an [N + R, F] output at ``d_lo``, in chunk order on one stream
(repeats are bitwise; a destination cut by a chunk boundary gets two partial
adds). The padding slots lie past ``row_ptr[R]`` and are never read. The JAX
package's chunk reductions, the one-hot MXU rank reduction
(``_rank_geometry``, ``_rank_segment_sum``) and its ``segment_sum``
fallback, are TPU machinery: every ``segment_backend`` runs K1 here, and the
value is checked as there. The JAX transfer schedule ``_overlapped`` (issue
the next put, then force the current one by a readback) works around the
TPU's proxied transport; here two pinned staging buffers alternate: the host
packs one while the other's copy (``non_blocking``, on a copy stream) and
the previous chunk's reduction run, the compute stream waits on the copy's
event, and a buffer is packed again only after its copy's event.

:class:`DistEdgeStream` (the JAX class's constructor, checks and geometry)
gives each part of a 1-D node partition the in-edges of its destination
range; :meth:`DistEdgeStream.spmm_host` gathers each chunk's unique source
rows on the host and lays the chunk CSRs of all the parts of a process end to
end over them, one K1 launch a chunk, through the same two pinned buffers,
each chunk as long as its own counts need.

Host offsets are Python ints (the edge count may pass 2^31); device indices
are chunk-local or node ids, int32.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from gnn_tpu_torch.ops.cuda.spmm import csr_spmm

__all__ = [
    "EdgeStream",
    "streaming_spmm",
    "streaming_spmm_grad",
    "DistEdgeStream",
    "device_put_slabbed",
]

_INT32_MAX = np.iinfo(np.int32).max
RANK_CK = 512  # the JAX rank reduction's sub-chunk: 'rank' needs chunk_edges % RANK_CK == 0


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def device_put_slabbed(arr, *, slab_bytes: int = 128 << 20, device=None) -> torch.Tensor:
    """Copy a large host array (numpy or memmap) to the device slab by slab.

    One device tensor of the array's shape is allocated first and filled in
    row slabs of at most ``slab_bytes`` through two alternating pinned
    buffers (``non_blocking`` copies, each buffer refilled after its copy's
    event), so the host never holds a second whole copy and the device never
    concatenates. ``device`` defaults to the card; on the CPU the slabs are
    plain copies."""
    arr = np.asarray(arr)
    device = torch.device("cuda" if device is None else device)
    out = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), device=device)
    if arr.size == 0:
        return out
    rows = arr.reshape(arr.shape[0] if arr.ndim else 1, -1)
    dst = out.view(rows.shape)
    per = max(1, int(slab_bytes // max(rows[:1].nbytes, 1)))
    if device.type != "cuda":
        for lo in range(0, rows.shape[0], per):
            dst[lo : lo + per].copy_(torch.from_numpy(np.array(rows[lo : lo + per])))
        return out
    per = min(per, rows.shape[0])
    stages = [torch.empty((per, rows.shape[1]), dtype=out.dtype, pin_memory=True) for _ in range(2)]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    with torch.cuda.device(device):
        for i, lo in enumerate(range(0, rows.shape[0], per)):
            n = min(per, rows.shape[0] - lo)
            stage, done = stages[i % 2], copied[i % 2]
            done.synchronize()  # the copy that last read this buffer has finished
            np.copyto(stage[:n].numpy(), rows[lo : lo + n])
            dst[lo : lo + n].copy_(stage[:n], non_blocking=True)
            done.record()
    return out


class EdgeStream:
    """Host-resident dst-sorted edge list cut into fixed-size chunks.

    Accepts numpy arrays or ``np.memmap`` (for graphs bigger than memory the
    caller memmaps the .npy files, sorted, with ``assume_sorted=True``)."""

    def __init__(
        self,
        edge_index,
        edge_weight=None,
        *,
        num_nodes: int,
        chunk_edges: int = 1 << 22,
        assume_sorted: bool = False,
        min_range_rows: int = 0,
    ):
        src = np.asarray(edge_index[0])
        dst = np.asarray(edge_index[1])
        if num_nodes > _INT32_MAX:
            raise ValueError(
                f"num_nodes={num_nodes} exceeds int32 — device node ids "
                "would overflow; shard the node space first"
            )
        self.num_edges = int(src.shape[0])
        self.num_nodes = int(num_nodes)
        self.chunk_edges = int(chunk_edges)
        if not assume_sorted:
            order = np.argsort(dst, kind="stable")
            src, dst = src[order], dst[order]
            if edge_weight is not None:
                edge_weight = np.asarray(edge_weight)[order]
        elif self.num_edges and np.any(np.diff(dst) < 0):
            raise ValueError("assume_sorted=True but dst is not sorted")
        self.src = np.ascontiguousarray(src, np.int32)
        self.dst = np.ascontiguousarray(dst, np.int32)
        self.weight = None if edge_weight is None else np.ascontiguousarray(edge_weight, np.float32)
        self.num_chunks = max(1, math.ceil(self.num_edges / self.chunk_edges))
        # One destination span for every chunk (the JAX package compiles one
        # step for all of them): the widest chunk's, rounded up to 8 rows.
        spans = [int(min_range_rows)]
        for c in range(self.num_chunks):
            lo, hi = self._bounds(c)
            spans.append(int(self.dst[hi - 1]) - int(self.dst[lo]) + 1 if hi > lo else 1)
        self.range_rows = ((max(spans) + 7) // 8) * 8

    def _bounds(self, c: int) -> Tuple[int, int]:
        lo = c * self.chunk_edges  # Python ints: E may pass 2^31
        return lo, min(lo + self.chunk_edges, self.num_edges)

    @property
    def packed_len(self) -> int:
        """Length of one :meth:`chunks_packed` buffer, in int32 words."""
        C = self.chunk_edges
        return C + self.range_rows + 1 + (C if self.weight is not None else 0)

    def transpose(self) -> "EdgeStream":
        """The reversed-edge stream (dst-sorted by the original sources): the
        structure of A^T, for the streamed backward dx = A^T g."""
        return EdgeStream(
            np.stack([self.dst, self.src]),
            self.weight,
            num_nodes=self.num_nodes,
            chunk_edges=self.chunk_edges,
        )

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]]:
        """Yield (src_chunk, dst_local_chunk, weight_chunk, d_lo) with fixed
        shapes [chunk_edges]; padding slots carry src=0, dst_local=range_rows,
        weight=0."""
        C = self.chunk_edges
        for c in range(self.num_chunks):
            lo, hi = self._bounds(c)
            n = hi - lo
            d_lo = int(self.dst[lo]) if n else 0
            src = np.zeros(C, np.int32)
            dstl = np.full(C, self.range_rows, np.int32)
            src[:n] = self.src[lo:hi]
            dstl[:n] = self.dst[lo:hi] - d_lo
            w = None
            if self.weight is not None:
                w = np.zeros(C, np.float32)
                w[:n] = self.weight[lo:hi]
            yield src, dstl, w, d_lo

    def chunks_rle(self) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]]:
        """Like :meth:`chunks` with the sorted local destinations run-length
        encoded: yields (src, counts [range_rows + 1] int32, weight, d_lo);
        counts[r] = edges of local row r, counts[range_rows] the padding."""
        R = self.range_rows
        for src, dstl, w, d_lo in self.chunks():
            yield src, np.bincount(dstl, minlength=R + 1).astype(np.int32), w, d_lo

    def chunks_packed(self) -> Iterator[Tuple[np.ndarray, int]]:
        """One contiguous int32 buffer per chunk: [src (C) | counts (R + 1) |
        weight bits (C, only if weighted)], and d_lo."""
        for c in range(self.num_chunks):
            buf = np.empty(self.packed_len, np.int32)
            _, d_lo = self.pack(c, buf)
            yield buf, d_lo

    def pack(self, c: int, buf: np.ndarray) -> Tuple[int, int]:
        """Write chunk c's :meth:`chunks_packed` buffer into ``buf`` (e.g. a
        pinned staging buffer) without a temporary of the chunk's size.
        Returns (edges in the chunk, d_lo)."""
        C, R = self.chunk_edges, self.range_rows
        lo, hi = self._bounds(c)
        n = hi - lo
        d_lo = int(self.dst[lo]) if n else 0
        buf[:n] = self.src[lo:hi]
        buf[n:C] = 0
        counts = buf[C : C + R + 1]
        counts[:R] = np.bincount(self.dst[lo:hi] - np.int32(d_lo), minlength=R)
        counts[R] = C - n
        if self.weight is not None:
            w = buf[C + R + 1 :].view(np.float32)
            w[:n] = self.weight[lo:hi]
            w[n:] = 0
        return n, d_lo


class _Staging:
    """Two pinned host buffers, their device twins and the events that
    order them (see the module docstring); on the CPU one plain buffer.
    ``stats`` (a dict or None) collects the host's pack time and, on the
    card, CUDA events around each copy and each chunk's K1 launch. A chunk
    longer than its buffer gets a larger one."""

    def __init__(self, length: int, device: torch.device, stats: Optional[dict]):
        self.cuda, self.device = device.type == "cuda", device
        self.stats, self.pack_s, self.bytes, self.events = stats, 0.0, 0, {"copy": [], "k1": []}
        if not self.cuda:
            self.host = self.dev = [torch.empty(length, dtype=torch.int32)] * 2
            return
        self.compute = torch.cuda.current_stream(device)  # where K1 and the adds run
        self.host = [torch.empty(length, dtype=torch.int32, pin_memory=True) for _ in range(2)]
        self.dev = [torch.empty(length, dtype=torch.int32, device=device) for _ in range(2)]
        self.copy_stream = torch.cuda.Stream(device)
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]  # a buffer's copy has landed
        self.consumed = [torch.cuda.Event(), torch.cuda.Event()]  # its chunk's reduction has read it

    def _grow(self, i: int, length: int) -> None:
        """Buffer pair i, ``length`` words long; its last copy has landed."""
        length = max(length, self.host[i].numel() * 5 // 4)  # a few reallocations as the chunks grow
        if not self.cuda:
            self.host[i] = torch.empty(length, dtype=torch.int32)
            return
        self.host[i] = torch.empty(length, dtype=torch.int32, pin_memory=True)
        self.dev[i] = torch.empty(length, dtype=torch.int32, device=self.device)
        # the new device buffer may reuse memory that work already enqueued
        # on the compute stream reads: the next copy into it waits for that
        self.consumed[i].record(self.compute)

    def timed(self, kind: str):
        """A pair of CUDA events to record around work, when stats are kept."""
        if self.stats is None or not self.cuda:
            return None
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.events[kind].append(pair)
        return pair

    def record(self, event, stream=None) -> None:
        if event is not None:
            event.record(stream or self.compute)

    def put(self, pack, c: int, length: int):
        """Chunk c's packed buffer of ``length`` int32 words on the device,
        ordered before the work that the compute (current) stream enqueues
        next, and what ``pack(host_buffer)`` returned after writing it."""
        i = c % 2
        if self.cuda:
            self.copied[i].synchronize()  # the copy that last read host[i] has finished
        if length > self.host[i].numel():
            self._grow(i, length)
        t0 = time.perf_counter()
        packed = pack(self.host[i][:length].numpy())
        self.pack_s += time.perf_counter() - t0
        self.bytes += 4 * length
        if self.cuda:
            start, end = self.timed("copy") or (None, None)
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(self.consumed[i])  # chunk c - 2 is done with dev[i]
                self.record(start, self.copy_stream)
                self.dev[i][:length].copy_(self.host[i][:length], non_blocking=True)
                self.record(end, self.copy_stream)
                self.record(self.copied[i], self.copy_stream)
            self.compute.wait_event(self.copied[i])
        return self.dev[i][:length], packed

    def done(self, c: int) -> None:
        """The compute stream has enqueued everything that reads chunk c."""
        if self.cuda:
            self.record(self.consumed[c % 2])

    def report(self, num_chunks: int, num_edges: int) -> None:
        if self.stats is None:
            return
        ms = {}
        if self.cuda:
            self.compute.synchronize()
            self.copy_stream.synchronize()
            ms = {f"{k}_ms": [a.elapsed_time(b) for a, b in pairs] for k, pairs in self.events.items()}
        self.stats.update(
            chunks=num_chunks, edges=num_edges, h2d_bytes=self.bytes, pack_ms=self.pack_s * 1e3, **ms,
        )


def _check_backend(stream: EdgeStream, segment_backend: str) -> None:
    """The JAX package's checks of ``segment_backend``; every value runs K1."""
    if segment_backend not in ("auto", "rank", "scatter"):
        raise ValueError(f"unknown segment_backend '{segment_backend}'")
    if segment_backend == "rank" and not (stream.chunk_edges % RANK_CK == 0 and stream.num_edges):
        raise ValueError(f"rank backend needs chunk_edges % {RANK_CK} == 0")


def streaming_spmm(
    stream: EdgeStream,
    x: torch.Tensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    norm: Optional[torch.Tensor] = None,
    segment_backend: str = "auto",
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """out = A @ x with A streamed from the host chunk by chunk, one K1
    launch a chunk (see the module docstring).

    Device memory: x, out, two packed chunk buffers and K1's [range_rows, F]
    partial, whatever the edge count. ``norm``: an optional [num_nodes]
    float32 vector on x's device; the per-edge weight norm[src] * norm[dst]
    is then computed on the device (e.g. the d^-1/2 factors of ``gcn_norm``)
    and no weights ship. Mutually exclusive with baked edge weights.
    ``segment_backend`` ('auto', 'rank', 'scatter') is checked as in the JAX
    package and changes nothing. ``stats``: a dict to fill with ``chunks``,
    ``edges``, ``h2d_bytes``, the host's ``pack_ms`` (all chunks) and, on
    the card, the per-chunk CUDA-event times ``copy_ms`` and ``k1_ms``;
    keeping them synchronises the device once at the end.

    Not differentiable: :func:`streaming_spmm_grad` is.
    """
    if norm is not None and stream.weight is not None:
        raise ValueError("pass either baked edge weights or norm, not both")
    _check_backend(stream, segment_backend)
    if x.ndim != 2 or x.shape[0] != stream.num_nodes:
        raise ValueError(f"x must be [{stream.num_nodes}, F], got {tuple(x.shape)}")
    C, R, N, F = stream.chunk_edges, stream.range_rows, stream.num_nodes, x.shape[1]
    x = x.contiguous()
    out = torch.zeros((N + R, F), dtype=out_dtype or x.dtype, device=x.device)
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=x.device)
    staging = _Staging(stream.packed_len, x.device, stats)
    for c in range(stream.num_chunks):
        packed, (n, d_lo) = staging.put(lambda buf: stream.pack(c, buf), c, stream.packed_len)
        if n:
            counts = packed[C : C + R]
            torch.cumsum(counts, 0, dtype=torch.int32, out=row_ptr[1:])
            src = packed[:n]
            if norm is not None:
                dst = torch.repeat_interleave(counts, output_size=n).add_(d_lo)
                w = norm.index_select(0, src) * norm.index_select(0, dst)
            elif stream.weight is not None:
                w = packed[C + R + 1 : C + R + 1 + n].view(torch.float32)
            else:
                w = None
            start, end = staging.timed("k1") or (None, None)
            staging.record(start)
            part = csr_spmm(row_ptr, src, w, x)
            staging.record(end)
            out[d_lo : d_lo + R] += part.to(out.dtype)
        staging.done(c)
    staging.report(stream.num_chunks, stream.num_edges)
    return out[:N]


class _StreamingSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stream, t_stream, norm):
        ctx.t_stream, ctx.norm = t_stream, norm
        return streaming_spmm(stream, x, norm=norm)

    @staticmethod
    def backward(ctx, g):
        return streaming_spmm(ctx.t_stream, g, norm=ctx.norm), None, None, None


def streaming_spmm_grad(
    stream: EdgeStream,
    t_stream: EdgeStream,
    x: torch.Tensor,
    *,
    norm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable streamed SpMM: the forward streams ``stream``, the
    backward streams ``t_stream`` (``stream.transpose()``) for dx = A^T g,
    A never on the device. Edge weights and ``norm`` are constants; ``norm``
    is per node and symmetric per edge, so it serves both directions."""
    return _StreamingSpmm.apply(x, stream, t_stream, norm)


def _rank_geometry(dst_sorted: np.ndarray, chunk_edges: int) -> Tuple[int, int]:
    """The JAX rank reduction's static geometry (``gnn_tpu/graphs/
    streaming.py:211-232``): over all chunks, the most distinct destinations
    in a ``RANK_CK``-edge window (H) and in a chunk (K, one rank more for
    the padding slots), each rounded up to 8. Kept for the geometry's
    parity: every chunk here is one K1 launch."""
    C, H, K = int(chunk_edges), 1, 1
    for lo in range(0, max(len(dst_sorted), 1), C):
        d = dst_sorted[lo : lo + C]
        if len(d) == 0:
            continue
        rank = np.empty(len(d), np.int64)
        rank[0] = 0
        np.cumsum(np.diff(d) != 0, out=rank[1:])
        K = max(K, int(rank[-1]) + 2)
        idx = np.arange(0, len(d), RANK_CK)
        ends = np.minimum(idx + RANK_CK, len(d)) - 1
        H = max(H, int((rank[ends] - rank[idx]).max()) + 2)
    return ((H + 7) // 8) * 8, ((K + 7) // 8) * 8


class DistEdgeStream:
    """Streamed aggregation over the parts of a node partition, with the
    edges *and* the features on the host (the ogbn-papers100M regime).

    Port of ``gnn_tpu/graphs/streaming.py::DistEdgeStream``, with its
    constructor, checks and geometry: part p (of ``num_parts``; ``n_max =
    ceil(N / P)`` rounded up to 8) owns the destinations ``[p n_max, (p + 1)
    n_max)`` and streams only their in-edges (``streams[p]``, an
    :class:`EdgeStream` with global sources and part-local destinations), all
    parts sharing one ``range_rows`` and ``num_chunks``. Each chunk ships,
    beside its edges, the unique source rows it reads, gathered on the host
    from ``x_host`` (a numpy array or a memmap): neither x nor the edges ever
    lie whole on the device, and no collective runs (the halo is resolved
    through the stream).

    ``u_sizes`` (the unique sources of each part's chunks) and ``u_max``
    (their largest, at least 8, rounded up to 8) equal the JAX values; they
    are computed when first read, not in the constructor (the JAX class
    makes a first ``np.unique`` pass over every chunk there, which
    :meth:`spmm_host` repeats). ``rank_h`` and ``rank_k`` are the JAX rank
    reduction's geometry, kept for parity (computed when read; nothing here
    uses them). Where the JAX step pads every chunk's feature section to
    ``u_max``, each chunk here ships its own count of rows."""

    def __init__(
        self,
        edge_index,
        edge_weight=None,
        *,
        num_nodes: int,
        num_parts: int,
        chunk_edges: int = 1 << 20,
    ):
        src = np.asarray(edge_index[0], np.int64)
        dst = np.asarray(edge_index[1], np.int64)
        w = None if edge_weight is None else np.asarray(edge_weight, np.float32)
        P = int(num_parts)
        self.num_parts = P
        self.num_nodes = int(num_nodes)
        self.num_edges = int(src.shape[0])
        self.chunk_edges = int(chunk_edges)
        n_max = -(-self.num_nodes // P)
        self.n_max = ((n_max + 7) // 8) * 8
        # a part's in-edges: sources global (the host gathers x by them),
        # destinations local to the part
        streams = []
        for p in range(P):
            lo, hi = p * self.n_max, min((p + 1) * self.n_max, self.num_nodes)
            m = (dst >= lo) & (dst < hi)
            streams.append(EdgeStream(
                np.stack([src[m], dst[m] - lo]), None if w is None else w[m],
                num_nodes=self.n_max, chunk_edges=self.chunk_edges,
            ))
        # one destination span for every part's chunks
        R = max(s.range_rows for s in streams)
        self.streams = [
            EdgeStream(
                np.stack([s.src, s.dst]), s.weight, num_nodes=self.n_max, chunk_edges=self.chunk_edges,
                assume_sorted=True, min_range_rows=R,
            )
            for s in streams
        ]
        self.range_rows = R
        self.num_chunks = max(s.num_chunks for s in self.streams)
        self.has_weight = w is not None
        self._u_sizes = self._rank = None

    @property
    def u_sizes(self) -> list:
        """The unique sources of each part's chunks, [P][num_chunks of the part]."""
        if self._u_sizes is None:
            self._u_sizes = [
                [len(self._chunk_uniq(p, c)[0]) for c in range(s.num_chunks)] for p, s in enumerate(self.streams)
            ]
        return self._u_sizes

    @property
    def u_max(self) -> int:
        u_max = max(8, max((u for row in self.u_sizes for u in row), default=8))
        return ((u_max + 7) // 8) * 8

    def _rank_geometry(self) -> Tuple[int, int]:
        if self._rank is None:
            shapes = [
                _rank_geometry(s.dst, self.chunk_edges) if self.chunk_edges % RANK_CK == 0 and s.num_edges else (0, 0)
                for s in self.streams
            ]
            if any(h == 0 for h, _ in shapes):
                self._rank = (0, 0)
            else:
                self._rank = (max(h for h, _ in shapes), max(k for _, k in shapes))
        return self._rank

    @property
    def rank_h(self) -> int:
        return self._rank_geometry()[0]

    @property
    def rank_k(self) -> int:
        return self._rank_geometry()[1]

    def _chunk_uniq(self, p: int, c: int) -> Tuple[np.ndarray, np.ndarray]:
        """(the unique sources of part p's chunk c, ascending, int64; each
        edge's slot among them, int32): the JAX class's ``np.unique``, here
        ``torch.unique`` on the host's threads."""
        lo, hi = self.streams[p]._bounds(c)
        uniq, inv = torch.unique(torch.from_numpy(self.streams[p].src[lo:hi]), sorted=True, return_inverse=True)
        return uniq.long().numpy(), inv.to(torch.int32).numpy()

    def spmm_host(
        self,
        x_host: np.ndarray,
        mesh,
        *,
        axis_name: str = "data",
        out_dtype: Optional[torch.dtype] = None,
        stats: Optional[dict] = None,
    ) -> torch.Tensor:
        """out = A @ x over the mesh's parts with A *and* x on the host.

        ``x_host``: [num_nodes, F] float32, a numpy array or a memmap; each
        chunk ships only the unique source rows its edges read. A chunk of
        this process's parts is **one K1 launch** (``ops/cuda/spmm.py``):
        their chunk CSRs are laid end to end, part after part (``range_rows``
        rows each, the columns the part's rows in a stacked ``[sum of the
        parts' unique counts, F]`` feature section), and each part's
        ``[range_rows, F]`` partial is added into its ``[n_max + range_rows,
        F]`` slab at the chunk's first destination. The packed chunk
        ``[row_ptr | col | weight bits (weighted) | feature bits]`` goes over
        through the two pinned buffers, the copy stream and the events of
        :func:`streaming_spmm`, sized by the chunk's own counts.

        Returns, in one process (every part on ``mesh.device``), the [N, F]
        result; in a ``torch.distributed`` group, this process's rows in the
        partition's padded layout, ``[L n_max, F]`` for its L parts (as
        :meth:`~gnn_tpu_torch.parallel.DistGraph.shard_nodes` lays them).
        Forward only: at this scale training takes the host-feature sampled
        path (``train/host_loader.py``), as in the JAX package.

        The host's gather of the unique rows is ``torch.index_select`` on its
        threads, straight into the pinned staging buffer.

        ``stats``: a dict to fill with ``chunks`` (K1 launches), ``edges``,
        ``h2d_bytes``, ``max_chunk_bytes`` (a staging buffer's size),
        ``rows_shipped`` and the host's ``unique_ms``, ``gather_ms`` and
        ``pack_ms`` (sums over the chunks), and on the card the per-chunk
        CUDA-event ``copy_ms`` and ``k1_ms``."""
        if mesh.shape.get(axis_name) != self.num_parts:
            raise ValueError(f"the mesh's '{axis_name}' axis has {mesh.shape.get(axis_name)} parts, the stream {self.num_parts}")
        if not isinstance(x_host, np.ndarray):
            x_host = np.asarray(x_host)
        if x_host.ndim != 2 or x_host.shape[0] != self.num_nodes:
            raise ValueError(f"x_host must be [{self.num_nodes}, F], got {tuple(x_host.shape)}")
        if x_host.dtype != np.float32:
            raise ValueError(f"x_host must be float32 (its rows ship as int32 words), got {x_host.dtype}")
        F, R, device = int(x_host.shape[1]), self.range_rows, mesh.device
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # a read-only memmap: only read here
            x_rows = torch.from_numpy(x_host)
        first, L = mesh.first_part, mesh.num_local_parts
        local = [self.streams[p] for p in range(first, first + L)]
        out = torch.zeros((L, self.n_max + R, F), dtype=out_dtype or torch.float32, device=device)
        staging = _Staging(0, device, stats)
        times = dict(unique=0.0, gather=0.0, pack=0.0)
        shipped = launches = biggest = 0
        for c in range(max(s.num_chunks for s in local)):
            # the parts of this process with edges in chunk c, their edges and unique sources
            active, edges, uniq, inv = [], [], [], []
            t0 = time.perf_counter()
            for l, s in enumerate(local):
                lo, hi = s._bounds(c)
                if c < s.num_chunks and hi > lo:
                    u, slots = self._chunk_uniq(first + l, c)
                    active.append(l)
                    edges.append((s, lo, hi))
                    uniq.append(u)
                    inv.append(slots)
            times["unique"] += time.perf_counter() - t0
            if not active:
                continue
            n, U = sum(hi - lo for _, lo, hi in edges), sum(len(u) for u in uniq)
            o_col = len(active) * R + 1
            o_w = o_col + n
            o_feat = o_w + (n if self.has_weight else 0)
            d_los = [int(s.dst[lo]) for s, lo, _ in edges]

            def pack(buf: np.ndarray) -> None:
                t0 = time.perf_counter()
                counts = np.zeros(len(active) * R, np.int64)
                e = u_off = 0
                for a, ((s, lo, hi), u, slots) in enumerate(zip(edges, uniq, inv)):
                    counts[a * R : (a + 1) * R] = np.bincount(s.dst[lo:hi] - np.int32(d_los[a]), minlength=R)
                    np.add(slots, np.int32(u_off), out=buf[o_col + e : o_col + e + hi - lo])
                    if self.has_weight:
                        buf[o_w + e : o_w + e + hi - lo] = s.weight[lo:hi].view(np.int32)
                    e, u_off = e + hi - lo, u_off + len(u)
                buf[0] = 0
                np.cumsum(counts, out=buf[1:o_col], dtype=np.int32)
                t1 = time.perf_counter()
                feats = torch.from_numpy(buf[o_feat:].view(np.float32).reshape(U, F))
                u_off = 0
                for u in uniq:
                    torch.index_select(x_rows, 0, torch.from_numpy(u), out=feats[u_off : u_off + len(u)])
                    u_off += len(u)
                times["pack"] += t1 - t0
                times["gather"] += time.perf_counter() - t1

            packed, _ = staging.put(pack, c, o_feat + U * F)
            shipped, biggest = shipped + U, max(biggest, 4 * (o_feat + U * F))
            w = packed[o_w:o_feat].view(torch.float32) if self.has_weight else None
            feats = packed[o_feat:].view(torch.float32).view(U, F)
            start, end = staging.timed("k1") or (None, None)
            staging.record(start)
            part = csr_spmm(packed[:o_col], packed[o_col:o_w], w, feats)
            staging.record(end)
            launches += 1
            for a, l in enumerate(active):
                out[l, d_los[a] : d_los[a] + R] += part[a * R : (a + 1) * R].to(out.dtype)
            staging.done(c)
        staging.report(launches, sum(s.num_edges for s in local))
        if stats is not None:
            stats.update(rows_shipped=shipped, max_chunk_bytes=biggest, **{f"{k}_ms": v * 1e3 for k, v in times.items()})
        out = out[:, : self.n_max].reshape(L * self.n_max, F)
        return out if mesh.grouped else out[: self.num_nodes]
