"""Host ms per step inside the port's ``sampled.sample`` and
``sampled.gather`` ranges: the sampler and the x[nodes] gather as the host
sees them (the seeds' copy to the card included)."""

from gnnbench import trace as tr


def read(t):
    ranges = tr.host_ranges(t.events, {"sampled.sample", "sampled.gather"})
    return sum(tr.duration_us(e) for e in ranges) / 1e3 / t.steps if ranges else None
