#!/usr/bin/env python3
"""Where a 1x1 mesh's host time goes, on one NVIDIA H100: qwen2.5-3b's
train step at full width (bf16, remat full, B8 x S512) and smollm-360m's
``generate`` (8 x 512 -> 32), each unsharded and on a 1x1 (data, model)
mesh of an NCCL world of one, in one process on the same weights. Run from
the root of a checkout:

    python3 benchmarks/torch_mesh_profile.py [--steps 3] [--top 20]

For each of the four: the wall time (host clock after a synchronize: the
train step's median of ``steps`` after one untimed step, ``generate``'s
decode ms a token after one untimed call), then one more run under
``torch.profiler``: the device's busy time, the ATen ops called on the host
and their host time, and the ops by self host time, the mesh's beside the
unsharded run's (on a DTensor an op's self time is DTensor's dispatch,
sharding propagation and redistribution around the local op, which is its
child); and one more under ``cProfile``: host time by Python source
(DTensor's package, the port, the rest of torch), and the mesh's top
functions by own time. Prints the card's name and power limit first and a
JSON line last; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import json
import pstats
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def sync():
    torch.cuda.synchronize()


def traced(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall ms, device busy ms,
    ATen calls and their self host ms, and {op: (calls, self host ms)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
           if e.key.startswith("aten::")}
    return {"wall_ms": wall, "busy_ms": busy, "aten_calls": sum(c for c, _ in ops.values()),
            "aten_self_ms": sum(t for _, t in ops.values()), "ops": ops}


def python_profile(fn, top: int) -> dict:
    """One call of ``fn`` under cProfile: own time by source group, and the
    ``top`` functions by own time."""
    prof = cProfile.Profile()
    sync()
    prof.enable()
    fn()
    sync()
    prof.disable()
    stats = pstats.Stats(prof).stats
    groups = defaultdict(float)
    rows = []
    for (path, line, name), (_, calls, own, _, _) in stats.items():
        if "torch/distributed/tensor" in path:
            group = "DTensor (torch.distributed.tensor)"
        elif "repro_torch" in path:
            group = "the port (repro_torch)"
        elif "/torch/" in path:
            group = "the rest of torch's Python"
        elif path == "~":
            group = "C functions called from Python (ops, tensor methods)"
        else:
            group = "other Python"
        groups[group] += own * 1e3
        short = path.split("site-packages/")[-1].split("src/")[-1]
        rows.append((own * 1e3, calls, f"{short}:{line} {name}"))
    rows.sort(reverse=True)
    return {"groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top": [{"own_ms": t, "calls": c, "where": w} for t, c, w in rows[:top]]}


def compare(label: str, plain: dict, mesh: dict, top: int):
    print(f"{label}: unsharded wall {plain['wall_ms']:.2f} ms, device busy "
          f"{plain['busy_ms']:.2f} ms, {plain['aten_calls']} ATen calls, their self host "
          f"time {plain['aten_self_ms']:.2f} ms; 1x1 mesh wall {mesh['wall_ms']:.2f} ms, busy "
          f"{mesh['busy_ms']:.2f} ms, {mesh['aten_calls']} ATen calls, self host "
          f"{mesh['aten_self_ms']:.2f} ms (profiled runs)")
    print(f"  {'op':<44} {'mesh calls':>10} {'mesh ms':>9} {'plain calls':>11} {'plain ms':>9}")
    for op, (n, t) in sorted(mesh["ops"].items(), key=lambda kv: -kv[1][1])[:top]:
        pn, pt = plain["ops"].get(op, (0, 0.0))
        print(f"  {op:<44} {n:>10} {t:>9.2f} {pn:>11} {pt:>9.2f}")


def show_python(label: str, plain: dict, mesh: dict):
    print(f"{label}, cProfile own time by source (ms; the profiler's own cost inflates "
          "Python-heavy code):")
    for g in sorted(set(plain["groups_ms"]) | set(mesh["groups_ms"])):
        print(f"  {g:<56} mesh {mesh['groups_ms'].get(g, 0.0):9.2f}   unsharded "
              f"{plain['groups_ms'].get(g, 0.0):9.2f}")
    print("  the mesh's top functions by own time:")
    for row in mesh["top"]:
        print(f"    {row['own_ms']:8.2f} ms {row['calls']:>7} calls  {row['where']}")


def trim(d: dict, top: int) -> dict:
    """``traced``'s result with its op table cut to the ``top`` by host time."""
    ops = dict(sorted(d["ops"].items(), key=lambda kv: -kv[1][1])[:top])
    return {**d, "ops": ops}


def train(args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_env, make_mesh
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    from repro_torch.parallel import null_env, use_env

    cfg = get_config("qwen2.5-3b").replace(remat="full")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 512, 8, seed=0))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0, total_steps=100))
    holder = {"state": steps.init_train_state(cfg, 0, torch.device("cuda")), "i": 0}

    def one():
        holder["state"], _ = step(holder["state"], data.batch_at(holder["i"]))
        holder["i"] += 1

    def timed():
        one()
        sync()
        ms = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            one()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms), ms

    out = {}
    for mode in ("unsharded", "mesh"):
        env = (null_env() if mode == "unsharded"
               else make_env(make_mesh((1, 1), ("data", "model"), "cuda")))
        with use_env(env):
            if env.active:  # at 1x1 the placed leaves are the same tensors
                holder["state"] = steps.place_tree(holder["state"],
                                                   steps.train_state_shardings(cfg, env))
            med, ms = timed()
            out[mode] = {"step_ms": med, "runs_ms": ms, "trace": traced(one),
                         "python": python_profile(one, args.top)}
        print(f"qwen2.5-3b train step, {mode}: {med:.2f} ms (runs "
              f"{', '.join(f'{x:.2f}' for x in ms)})", flush=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del holder
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode(args) -> dict:
    from repro_torch.launch.serve import ServeEngine

    base = ServeEngine("smollm-360m", tiny=False, seed=0, device="cuda")
    prompts = base.synthetic_prompts(8, 512)
    out = {}
    for mode in ("unsharded", "mesh"):
        engine = base if mode == "unsharded" else ServeEngine(
            "smollm-360m", tiny=False, seed=0, device="cuda", mesh="1x1", params=base.params)
        engine.generate(prompts, 32)
        runs = [engine.generate(prompts, 32) for _ in range(args.steps)]
        dec = [r["decode_s"] / 31 * 1e3 for r in runs]
        pf = [r["prefill_s"] * 1e3 for r in runs]
        out[mode] = {"decode_ms_per_token": statistics.median(dec), "decode_runs": dec,
                     "prefill_ms": statistics.median(pf),
                     "trace": traced(lambda: engine.generate(prompts, 32)),
                     "python": python_profile(lambda: engine.generate(prompts, 32), args.top)}
        print(f"smollm-360m generate 8 x 512 -> 32, {mode}: decode "
              f"{out[mode]['decode_ms_per_token']:.3f} ms a token (runs "
              f"{', '.join(f'{x:.3f}' for x in dec)}), prefill {out[mode]['prefill_ms']:.2f} ms",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.launch.train import deterministic

    deterministic(torch.device("cuda"))
    init_process_group("cuda")
    results = {"card": smi.stdout.strip()}
    try:
        results["train"] = train(args)
        results["decode"] = decode(args)
    finally:
        torch.distributed.destroy_process_group()
    for name, label in (("train", "qwen2.5-3b train step"), ("decode", "smollm-360m generate")):
        r = results[name]
        compare(label, r["unsharded"]["trace"], r["mesh"]["trace"], args.top)
        show_python(label, r["unsharded"]["python"], r["mesh"]["python"])
        for mode in ("unsharded", "mesh"):
            r[mode]["trace"] = trim(r[mode]["trace"], args.top)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
