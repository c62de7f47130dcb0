"""Reading the port's spans (``gnn_tpu_torch/utils/tracing.py::span``) in a
trace: the device operations inside a set of spans, and the host's time in
them. On the card a span's copy covers the operations launched inside it
and not inside a span nested in it, so a set names the nested spans too.
An operation inside several of the set's ranges counts once."""

from bisect import bisect_right

from gnnbench import trace as tr
from gnnbench.metrics import device_ms_per_step


def merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def device_ms_inside(t, names):
    """Device ms per step of the operations that lie inside the union of
    the device ranges named in ``names``; None where there is none."""
    spans = merged(tr.device_ranges(t.events, set(names)))
    if not spans:
        return None
    starts = [lo for lo, _ in spans]

    def inside(e):
        i = bisect_right(starts, e.time_range.start) - 1
        return i >= 0 and e.time_range.end <= spans[i][1]

    return device_ms_per_step(t, inside) or None


def host_ms(t, names):
    """Host ms per step in the union of the host ranges named in ``names``;
    None where there is none."""
    ranges = tr.host_ranges(t.events, set(names))
    if not ranges:
        return None
    return tr.union_us((e.time_range.start, e.time_range.end) for e in ranges) / 1e3 / t.steps
