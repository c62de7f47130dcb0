"""Per-layer metric readers: ``<metric>.py`` for each per-layer metric of
``BENCHMARK.json``, found by the metric's name. Each defines
``read(t) -> float | None`` over a :class:`gnnbench.bench.Traced` (the traced
steps' events, their window and busy time, the port's launch counters per
step, the cell's shapes and its FLOP module); ``None`` where the trace holds
nothing to read, and the metric is then left out of the line."""

from gnnbench import trace as tr


def device_ms_per_step(t, keep) -> float:
    """Device ms per traced step of the device operations ``keep`` selects."""
    return sum(tr.duration_us(e) for e in t.kernels if keep(e)) / 1e3 / t.steps


def roofline(t, kernel: str, counter: str):
    """The least time of a step's ``kernel`` calls, by the FLOP module's
    bounds, as a share of their device time; None where the kernel did not
    run or the port's counter shows other calls than the bounds size."""
    bounds = t.flops.kernel_bounds(t.spec.config, t.shapes).get(kernel, [])
    ms = device_ms_per_step(t, lambda e: tr.kernel_of(e.name) == kernel)
    if not ms or t.counters.get(counter) != len(bounds):
        return None
    return 100.0 * sum(b.bound_s for b in bounds) * 1e3 / ms
