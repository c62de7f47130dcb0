"""Run one cell of the port's benchmark once, on the card it finds.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks``: each number compared with its
limit, also the last lines on standard error). Exits non-zero, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or if
JAX or the JAX package was loaded. The program's build caches stay inside
the checkout, under ``build/``. The process runs on two fixed cores.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_CACHE = ROOT / "build" / "gnnbench"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    # One process on two fixed cores of those it may use, the same in every
    # run, as a training job pinned with taskset runs.
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[2:4] if len(cores) >= 4 else cores)
    from gnnbench.bench import main

    sys.exit(main(sys.argv[1:], T_START, ROOT))
