"""The score kernels' (``gnn::gatv2_score``) least time over their device
time, in %: the calls counted by the port's ``gatv2_score.launches`` and
``gatv2_score_bwd.launches``, sized from the cell's shapes by the FLOP
module's ``kernel_bounds()['gatv2_score']``. None where they did not run or
the counters show other calls than the bounds size."""

from gnnbench.metrics import device_ms_per_step

NAME = "gnn::gatv2_score"


def read(t):
    bounds = t.flops.kernel_bounds(t.spec.config, t.shapes).get("gatv2_score", [])
    ms = device_ms_per_step(t, lambda e: NAME in e.name)
    calls = t.counters.get("gatv2_score", 0) + t.counters.get("gatv2_score_bwd", 0)
    if not ms or calls != len(bounds):
        return None
    return 100.0 * sum(b.bound_s for b in bounds) * 1e3 / ms
