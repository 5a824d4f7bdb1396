"""A profiled window's device record, read from torch.profiler's raw Kineto
results, and the reductions every per-layer reader shares.

The session opens with one CUDA operation of its own, since Kineto drops a
session's first GPU records. ``kineto_results`` is read raw, not through
``events()``, whose event tree is slow to build at 100,000s of kernels.
"""

from __future__ import annotations

import bisect
import re

import torch

WINDOW = "bench.window"
NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")
# a gap shorter than this is named by its length, not by the host's op
NAMED_GAP_NS = 20_000


def profile(run, device):
    """Runs ``run()`` under the profiler; returns (its result, the record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities) as prof:
        torch.ones(1, device=device).sum().item()
        if cuda:
            torch.cuda.synchronize(device)
        with record_function(WINDOW):
            result = run()
            if cuda:
                torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    cpu, gpu = [], []
    for e in events:
        rec = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            gpu.append(rec)
        elif e.device_type() == DeviceType.CPU:
            cpu.append(rec + (e.start_thread_id(),))
    span = [r for r in cpu if r[0] == WINDOW]
    if not span:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = span[0][1], span[0][2]
    ops = sorted(r for r in gpu if lo <= r[1] and r[2] <= hi and r[0] != WINDOW)
    host = [r for r in cpu if r[0] != WINDOW and r[2] > lo and r[1] < hi]
    return result, {"window_ns": (lo, hi), "device_ops": ops,
                    "kernels": [r for r in ops if not NOT_KERNEL.match(r[0])], "host": host}


def union(intervals):
    """Merged [start, end) intervals of (start, end) pairs, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(record) -> int:
    return sum(b - a for a, b in union((r[1], r[2]) for r in record["device_ops"]))


def top_device_ops(record, n=10):
    """[(kernel name, seconds)] of the n names with most device time."""
    by = {}
    for name, a, b in record["device_ops"]:
        by[name] = by.get(name, 0) + (b - a)
    return [[name[:200], ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _host_op_at(host_by_thread, t):
    """The innermost host op running at time t on any thread (latest start
    among the ops that cover t), or None."""
    best = None
    for starts, recs in host_by_thread.values():
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 2000, -1), -1):
            name, a, b = recs[j][0], recs[j][1], recs[j][2]
            if b >= t:
                if best is None or a > best[1]:
                    best = (name, a)
                break
    return None if best is None else best[0]


def idle_gaps(record, n=10):
    """[(what the host was doing, seconds)]: the device's idle time in the
    window, each gap of at least NAMED_GAP_NS named by the innermost host op
    at its middle and summed by name; shorter gaps summed under one name."""
    lo, hi = record["window_ns"]
    busy = union((r[1], r[2]) for r in record["device_ops"])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    by_thread = {}
    for rec in sorted(record["host"], key=lambda r: r[1]):
        by_thread.setdefault(rec[3], []).append(rec)
    host = {tid: ([r[1] for r in recs], recs) for tid, recs in by_thread.items()}
    by = {}
    for a, b in gaps:
        if b - a < NAMED_GAP_NS:
            name = f"(gaps under {NAMED_GAP_NS // 1000} us)"
        else:
            name = _host_op_at(host, (a + b) // 2) or "(no host op)"
        by[name] = by.get(name, 0) + (b - a)
    return [[name[:200], ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
