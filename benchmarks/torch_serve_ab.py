#!/usr/bin/env python3
"""The port's serving engine from two source trees, decode and prefill
time side by side, on one NVIDIA H100. Run from the root of a checkout,
with another copy of the repo (for example an earlier commit's, unpacked by
``git archive`` into a directory that git ignores):

    python3 benchmarks/torch_serve_ab.py OTHER_DIR [--arch smollm-360m]
        [--pairs 10] [--reps 5] [--batch 8] [--prompt-len 512] [--gen 32]

Each run is a fresh process with its tree's ``src`` on the path (its
kernels built into its own ``build/kernels``): ``ServeEngine`` at full
width with seeded random weights, one untimed ``generate``, then ``reps``
timed ones, each read as decode ms a token and prefill ms (host clock after
a synchronize, as ``ServeEngine`` times them). The trees alternate which
runs first, pair by pair. Prints the card's name and power limit, each
run's median, and for each tree the median of its runs, their quartiles and
the pairs it won; exits non-zero without a card or when a run fails.
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
import json, statistics, sys, torch
from repro_torch.launch.serve import ServeEngine
arch, b, s, gen, reps = sys.argv[1], *map(int, sys.argv[2:6])
engine = ServeEngine(arch, tiny=False, device="cuda")
prompts = engine.synthetic_prompts(b, s)
engine.generate(prompts, gen)
dec, pf = [], []
for _ in range(reps):
    out = engine.generate(prompts, gen)
    dec.append(out["decode_s"] / (gen - 1) * 1e3)
    pf.append(out["prefill_s"] * 1e3)
print(json.dumps({"decode_ms": dec, "prefill_ms": pf}))
"""


def run(tree: Path, args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    done = subprocess.run(
        [sys.executable, "-c", CHILD, args.arch, str(args.batch), str(args.prompt_len),
         str(args.gen), str(args.reps)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"{tree}: exit {done.returncode}\n{done.stdout}{done.stderr}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
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
        order = ("this", "other") if i % 2 else ("other", "this")
        meds = {}
        for side in order:
            r = run(trees[side], args)
            meds[side] = {k: statistics.median(v) for k, v in r.items()}
            runs[side].append(meds[side])
            print(f"pair {i} {side}: decode {meds[side]['decode_ms']:.3f} ms/token "
                  f"(runs {', '.join(f'{x:.3f}' for x in r['decode_ms'])}), "
                  f"prefill {meds[side]['prefill_ms']:.2f} ms", flush=True)
    summary = {}
    for metric in ("decode_ms", "prefill_ms"):
        for side in runs:
            xs = [m[metric] for m in runs[side]]
            wins = sum(a[metric] < b[metric] for a, b in
                       zip(runs[side], runs["other" if side == "this" else "this"]))
            summary[f"{side} {metric}"] = {"median": statistics.median(xs),
                                           "quartiles": quartiles(xs), "pairs_won": wins}
    print(json.dumps({"arch": args.arch, "batch": args.batch, "prompt_len": args.prompt_len,
                      "gen": args.gen, "reps": args.reps, "pairs": args.pairs, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
