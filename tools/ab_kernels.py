"""The CUDA kernels of another source directory against this tree's, in one
process on one NVIDIA GPU.

    git archive <commit> gnn_tpu_torch/csrc | tar -x -C build/ab
    python3 tools/ab_kernels.py --old-csrc build/ab/gnn_tpu_torch/csrc [--out PATH]

``--old-csrc`` holds ``*.cu`` sources (an older commit's, or an edited copy
of this tree's) with the C entries ``gnn_csr_spmm_*`` (K1),
``gnn_segment_sum_*`` (K2) and ``gnn_gat_spmm_*`` (K3). The script builds them
into a second library with this tree's nvcc flags. It reads each entry's
argument list from the ``extern "C"`` definitions in the sources, of both
directories, and passes every argument by its name, so the two sides may
differ in their signatures: an entry without ``part`` gets no scratch, and a
K3 entry without ``w_index`` is given a permuted copy of the weights, made
inside the timed call.

On the arxiv-scale power-law graph of ``chip_smoke.py`` each row holds the
new result to the old (the smoke's tolerances) and is then timed in turns
old, new, new, old (median of 20 CUDA-event runs after 3 warm-ups each): K3
forward and transpose (``w_index = t_perm``) at (H, F) = (8, 32) and (1, 40)
in float32 and bfloat16, with the weights already rounded to x's dtype; K1 at
F = 256 and over ``col = t_perm`` at width 1, K2 at widths 8 and 256, in
float32. Both sides run through the same thin caller, since a CUDA-event
time on an empty queue includes the host's launch path. The old library and
its ptxas report go to ``build/gnn_tpu_torch/ab/``. ``--out`` also writes the
rows as JSON. It needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    GAT_HEADS, N_NODES, arxiv_scale_edges, attention_weights, compare, log, nvidia_smi, time_ms,
)
from gnn_tpu_torch.graphs import build_adjacency, gcn_norm  # noqa: E402
from gnn_tpu_torch.ops.cuda import _build, _launch  # noqa: E402

_ENTRY = re.compile(r"^int (gnn_\w+)\(([^)]*)\)\s*\{", re.M)
CSRC = pathlib.Path(_build.__file__).resolve().parents[2] / "csrc"


class Library:
    """A built kernel library and the argument names of its C entries."""

    def __init__(self, lib: ctypes.CDLL, csrc: pathlib.Path):
        self.lib, self.params = lib, {}
        for source in sorted(csrc.glob("*.cu")):
            for name, args in _ENTRY.findall(source.read_text()):
                decls = [a.split() for a in args.split(",")]
                self.params[name] = [d[-1] for d in decls]
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p if "*" in "".join(d) else ctypes.c_int for d in decls]
                fn.restype = ctypes.c_int

    def call(self, entry: str, out_shape, *, x, row_ptr, n_edges, col=None, w=None, w_index=None, **sizes):
        """Launches ``entry``_f32 or _bf16 on x (K2: the messages) and returns out."""
        name = f"{entry}_{_launch.check_features('x', x.view(x.shape[0], -1))}"
        params = self.params[name]
        n_rows = row_ptr.numel() - 1
        if w_index is not None and "w_index" not in params:
            w, w_index = w.index_select(0, w_index.long()), None
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        values = dict(sizes, row_ptr=row_ptr, col=col, w=w, w_index=w_index, x=x, msg=x, out=out,
                      n_rows=n_rows, n_edges=n_edges, stream=_launch.stream(x.device),
                      vec=int(sizes["F"] % 4 == 0
                              and _launch.vector_path(x.view(x.shape[0], -1), out.view(n_rows, -1))))
        if "part" in params:
            values["part"], values["part_row"] = _launch.reduce_scratch(
                self.lib, n_rows, n_edges, out[0].numel(), x.device)
        args = [values[p] for p in params]
        rc = getattr(self.lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args))
        _launch.raise_on_error(name, rc)
        return out


def build_old(csrc: pathlib.Path) -> Library:
    out = _build.build_dir() / "ab" / "libold.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(out),
           *map(str, sorted(csrc.glob("*.cu")))]
    done = subprocess.run(cmd, check=True, capture_output=True, text=True)
    out.with_suffix(".log").write_text(done.stdout + done.stderr)  # ptxas: registers and spills
    return Library(ctypes.CDLL(str(out)), csrc)


def in_turns(row: str, dtype, old, new, extra=None) -> dict:
    """Checks new against old, then times old, new, new, old (and each extra
    call once)."""
    compare(row, new(), old(), dtype)
    t = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
    res = dict(row=row, old_ms=[t[0], t[3]], new_ms=[t[1], t[2]],
               old_over_new=(t[0] + t[3]) / (t[1] + t[2]))
    for name, fn in (extra or {}).items():
        res[name] = time_ms(fn)
    log(json.dumps(res))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, type=pathlib.Path)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels.py needs a CUDA device")
    dev = torch.device("cuda")
    log(nvidia_smi())
    old, new = build_old(args.old_csrc), Library(_build.load(), CSRC)
    ei, w = gcn_norm(arxiv_scale_edges(), num_nodes=N_NODES, self_loops=True)
    adj = build_adjacency(ei, w, num_nodes=N_NODES).to(dev)
    n, e = adj.num_dst_nodes, adj.num_edges
    gen = torch.Generator(device=dev).manual_seed(1)
    t_perm = adj.t_perm.long()
    csr = dict(row_ptr=adj.row_ptr, col=adj.src, n_edges=e)
    t_csr = dict(row_ptr=adj.t_row_ptr, col=adj.t_col, n_edges=e)
    rows = []
    for H, F in GAT_HEADS:
        _, alpha32 = attention_weights(adj, H, gen)
        x32 = torch.randn(n, H, F, generator=gen, device=dev)
        g32 = torch.rand(n, H, F, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"({H},{F}) {str(dtype).removeprefix('torch.')}"
            x, g, alpha = x32.to(dtype), g32.to(dtype), alpha32.to(dtype).float()
            k3 = lambda lib, v, **kw: lib.call("gnn_gat_spmm", (n, H, F), x=v, w=alpha, H=H, F=F, **kw)
            rows.append(in_turns(f"K3 fwd {tag}", dtype, lambda: k3(old, x, **csr), lambda: k3(new, x, **csr)))
            rows.append(in_turns(
                f"K3 dh {tag}", dtype,
                lambda: k3(old, g, w_index=adj.t_perm, **t_csr),
                lambda: k3(new, g, w_index=adj.t_perm, **t_csr),
                # this tree's kernel after a permuted copy, and the copy alone
                extra={"new_copy_ms": lambda: new.call("gnn_gat_spmm", (n, H, F), x=g, H=H, F=F,
                                                       w=alpha.index_select(0, t_perm), **t_csr),
                       "copy_alone_ms": lambda: alpha.index_select(0, t_perm)},
            ))
    x = torch.randn(n, 256, generator=gen, device=dev)
    ge = torch.randn(e, 1, generator=gen, device=dev) * adj.weight[:, None]
    ex8 = torch.rand(e, 8, generator=gen, device=dev)
    msg = x.index_select(0, adj.src.long()) * adj.weight[:, None]
    for row, entry, kw in (
        ("K1 fwd F=256", "gnn_csr_spmm", dict(csr, x=x, w=adj.weight, F=256)),
        ("K1 t_perm [E,1]", "gnn_csr_spmm", dict(row_ptr=adj.t_row_ptr, col=adj.t_perm, n_edges=e, x=ge, F=1)),
        ("K2 [E,8]", "gnn_segment_sum", dict(row_ptr=adj.row_ptr, n_edges=e, x=ex8, F=8)),
        ("K2 F=256", "gnn_segment_sum", dict(row_ptr=adj.row_ptr, n_edges=e, x=msg, F=256)),
    ):
        shape = (n, kw["F"])
        rows.append(in_turns(f"{row} float32", torch.float32,
                             lambda: old.call(entry, shape, **kw), lambda: new.call(entry, shape, **kw)))
    log(nvidia_smi())
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
