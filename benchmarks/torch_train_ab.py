#!/usr/bin/env python3
"""The port's unsharded train step from two source trees, side by side, on
one NVIDIA H100. Run from the root of a checkout, with another copy of the
repo (for example an earlier commit's, unpacked by ``git archive`` into a
directory that git ignores):

    python3 benchmarks/torch_train_ab.py OTHER_DIR [--arch qwen2.5-3b]
        [--pairs 3] [--steps 3] [--batch 8] [--seq 512]

Each run is a fresh process with its tree's ``src`` on the path (its
kernels built into its own ``build/kernels``): the full-width config with
seeded random weights, bf16, remat full, deterministic algorithms (as the
train CLI runs on the card), one untimed step, then ``steps`` timed ones
on the synthetic stream (host clock after a synchronize). The trees
alternate which runs first, pair by pair. Prints the card's name and power
limit, each run's median step, and for each tree the median of its runs,
their quartiles and the pairs it won; exits non-zero without a card or
when a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys, time, torch
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.train import deterministic
from repro_torch.models import steps
from repro_torch.optim import adamw
arch, b, s, n = sys.argv[1], *map(int, sys.argv[2:5])
device = torch.device("cuda")
deterministic(device)
cfg = get_config(arch).replace(remat="full")
data = SyntheticLM(DataConfig(cfg.vocab_size, s, b, seed=0))
step = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0, total_steps=n + 1))
state = steps.init_train_state(cfg, 0, device)
state, _ = step(state, data.batch_at(0))
torch.cuda.synchronize()
times = []
for i in range(n):
    t0 = time.perf_counter()
    state, m = step(state, data.batch_at(i + 1))
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"step_ms": times, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
"""


def run(tree: Path, args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    done = subprocess.run(
        [sys.executable, "-c", CHILD, args.arch, str(args.batch), str(args.seq),
         str(args.steps)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"{tree}: exit {done.returncode}\n{done.stdout}{done.stderr}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    trees = {"this": ROOT, "other": args.other.resolve()}
    runs = {"this": [], "other": []}
    for i in range(args.pairs):
        for side in (("this", "other") if i % 2 else ("other", "this")):
            r = run(trees[side], args)
            runs[side].append(statistics.median(r["step_ms"]))
            print(f"pair {i} {side}: step {runs[side][-1]:.2f} ms (runs "
                  f"{', '.join(f'{x:.2f}' for x in r['step_ms'])}), peak "
                  f"{r['peak_gib']:.2f} GiB", flush=True)
    summary = {}
    for side, other in (("this", "other"), ("other", "this")):
        xs = runs[side]
        q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
        summary[f"{side} step_ms"] = {
            "median": statistics.median(xs), "quartiles": (q[0], q[2]), "runs": xs,
            "pairs_won": sum(a < b for a, b in zip(xs, runs[other]))}
    print(json.dumps({"arch": args.arch, "batch": args.batch, "seq": args.seq,
                      "steps": args.steps, "pairs": args.pairs, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
