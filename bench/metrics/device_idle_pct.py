"""The share of the profiled window in which no operation runs on the card:
100 minus the union of the device's intervals over the window."""

from bench.trace import busy_ns


def read(ctx):
    if not ctx["record"]["device_ops"]:
        return None
    lo, hi = ctx["record"]["window_ns"]
    return 100 * (1 - busy_ns(ctx["record"]) / (hi - lo))
