"""The port's spans and its hook for what a step draws.

* :func:`span`: ``with span("agg.spmm"): ...`` marks a region for a
  profiler. While a profiler records (``torch.profiler.profile``, the
  legacy ``torch.autograd.profiler.profile``, ``emit_nvtx``) it is
  ``torch.profiler.record_function(name)``: a user annotation on the host,
  and on the card a copy that spans the kernels launched inside it. With no
  profiler it is one shared null context, a check of the profiler's state
  and nothing more (an ungated ``record_function`` runs two dispatcher ops
  whether or not anything records). The profiler's state is read per call,
  so a span is recorded in exactly the steps a profiler's schedule keeps
  active.
* :func:`watch` and :func:`emit`: ``with watch(fn): ...`` calls
  ``fn(kind, **payload)`` for every :func:`emit` inside the block, in the
  calling thread. The program emits what its steps draw and what their loss
  is taken of: ``"dropout"`` (``x``, ``out``, the keep ``mask``, ``rate``;
  ``nn.dropout.dropout``), ``"cross_entropy"`` (``logits``;
  ``nn.losses.cross_entropy``) and ``"sample"`` (``nodes``;
  ``NeighborSampler.sample``). With nothing watching, :func:`emit` returns
  after one truthiness check.

The names of the spans, the layers they mark and what reads each are listed
in ``PERF.md``, section 3.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

import torch
from torch.profiler import record_function

__all__ = ["span", "watch", "emit"]

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_watchers: List[Callable] = []


def span(name: str):
    """A context manager that marks ``name`` for a profiler while one
    records, and the one shared null context otherwise."""
    return record_function(name) if _recording() else _OFF


@contextlib.contextmanager
def watch(fn: Callable):
    """Calls ``fn(kind, **payload)`` for every :func:`emit` inside the block."""
    _watchers.append(fn)
    try:
        yield fn
    finally:
        _watchers.remove(fn)


def emit(kind: str, **payload) -> None:
    """Hands ``payload`` to every function :func:`watch` registered."""
    if not _watchers:
        return
    for fn in tuple(_watchers):
        fn(kind, **payload)
