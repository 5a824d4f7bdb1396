"""The attention kernels' share of their roofline: the least time of one
forward and one backward a layer a step at the cell's shapes (bench.flops'
bounds: the work whatever implements it, recompute not counted), over the
device time of every kernel named ``flash_*`` in the profiled steps."""

import re

from bench.flops import attention_bound, attention_bwd_bound, dims

FLASH = re.compile(r"\bflash_")


def read(ctx):
    ns = sum(b - a for name, a, b in ctx["record"]["kernels"] if FLASH.search(name))
    if not ns:
        return None
    w, t = dims(ctx["config"]), ctx["traffic"]
    shape = (t["batch"], w["h"], w["kv"], t["seq"], w["hd"], True, 0, ctx["config"]["torch_dtype"])
    bound_ms = attention_bound(*shape)["bound_ms"] + attention_bwd_bound(*shape)["bound_ms"]
    return 100 * bound_ms * w["layers"] * ctx["steps"] / (ns / 1e6)
