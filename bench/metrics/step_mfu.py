"""The whole step's share of the card's peak in the profiled window: the
model FLOPs of its steps (bench.flops, from the configuration's widths) over
the window's length times the peak rate of the configuration's dtype."""


def read(ctx):
    if not ctx["record"]["device_ops"]:
        return None
    lo, hi = ctx["record"]["window_ns"]
    return 100 * ctx["flops_per_step"] * ctx["steps"] / ((hi - lo) / 1e9 * ctx["peak_flops"])
