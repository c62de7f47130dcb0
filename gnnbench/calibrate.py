"""The readings that the limits of a cell's comparison are set from.

    python3 gnnbench/calibrate.py --workload <cell> --seeds 11,12,... [--out FILE]

In one process, on the card, for each seed: the program's first steps as a
run takes them (set-up, the checked steps), judged and held to the plain
reference; then, in the program's place, the reference's control (float32
with TF32 matrix products, one precision below the configuration's float32)
and three planted faults: the loss over half of the batch, and the first
step's gradient doubled where it is made, of the first layer's weight (the
largest leaf) and of the last layer's bias (a small one). A step that
leaves the state unchanged reads 1 on every change and gradient number by
their definition and needs no run. Prints one JSON line a seed:
``program``, ``control``, ``half_batch``, ``altered_gradient`` and
``altered_bias``, each with every number of :func:`gnnbench.bench.gaps`.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gnnbench import bench, graphs  # noqa: E402
from gnnbench.reference import common  # noqa: E402


def double_first_leaf(step: int, grads: dict) -> None:
    """The first step's gradient of the first layer's weight, doubled."""
    if step == 0:
        grads["convs.0.lin.weight"] = grads["convs.0.lin.weight"] * 2


def double_last_bias(step: int, grads: dict) -> None:
    """The first step's gradient of the last layer's bias, a small leaf,
    doubled."""
    last = [k for k in grads if k.endswith(".bias")][-1]
    if step == 0:
        grads[last] = grads[last] * 2


def readings(spec: bench.Spec, seed: int, edges, device) -> dict:
    """Every reading of one seed."""
    t0 = time.perf_counter()
    prog = bench.build_program(spec, seed, edges, device)
    rd = bench.checked_steps(prog)
    prog.free()
    t1 = time.perf_counter()
    counts, masks, sample = bench.judge(spec, seed, edges, rd)
    out = {"seed": seed, "setup_and_checked_s": t1 - t0, "judged": counts}
    if masks is None:
        return out
    p0 = bench.initial_weights(spec, seed, device)
    ref = bench.reference_run(spec, seed, edges, masks, sample, device)
    t2 = time.perf_counter()
    out["reference_s"] = t2 - t1
    out["program"] = bench.gaps(bench.program_side(rd), ref, p0)
    planted = {
        "control": dict(prec=common.CONTROL),
        "half_batch": dict(half_batch=True),
        "altered_gradient": dict(alter=double_first_leaf),
        "altered_bias": dict(alter=double_last_bias),
    }
    for name, kwargs in planted.items():
        other = bench.reference_run(spec, seed, edges, masks, sample, device, **kwargs)
        out[name] = bench.gaps(other, ref, p0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    spec = bench.load_spec(ROOT, args.workload)
    edges = graphs.edges(spec.dataset, spec.traffic["graph"])
    spec.cell_edges = edges.shape[1]
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, **readings(spec, seed, edges, torch.device(args.device))})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
