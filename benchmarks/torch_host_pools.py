#!/usr/bin/env python3
"""The port's host work on a full-width model from two source trees, side by
side, on one NVIDIA H100 and its host: drawing the seeded weights, and
saving, checking and restoring a train state's checkpoint. Run from the
root of a checkout, with another copy of the repo (for example an earlier
commit's, unpacked by ``git archive`` into a directory that git ignores):

    python3 benchmarks/torch_host_pools.py OTHER_DIR [--pairs 2]
        [--draw smollm-360m,qwen2.5-3b] [--ckpt smollm-360m] [--device cuda]

Each run is a fresh process with its tree's ``src`` on the path. It times
``steps.init_params(cfg, 0, "cpu")`` for each ``--draw`` arch (full width,
bf16), then makes the ``--ckpt`` arch's train state on the card
(``init_train_state``, seed 3, one train step at B2 x S128 so that the
optimizer's moments are not zeros) and times ``checkpoint.save`` of it into
an in-memory bucket, ``is_valid`` (every blob hashed) and ``restore``, and
checks that the restored leaves equal the state's bit for bit. The trees
alternate which runs first, pair by pair (OTHER_DIR first).
Prints the card's name and power limit, each run's seconds, and the median
of each tree's runs; exits non-zero without a card or when a run fails or
a restore differs.
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
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import steps
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths


class Bucket:  # in memory, the interface checkpoints use
    def __init__(self):
        self.blobs = {}

    def write(self, key, data):
        self.blobs[key] = bytes(data)

    def read(self, key):
        return self.blobs[key]

    def exists(self, key):
        return key in self.blobs

    def listdir(self, prefix=""):
        return sorted(k for k in self.blobs if k.startswith(prefix))


draw, arch, device = sys.argv[1].split(","), sys.argv[2], torch.device(sys.argv[3])
out = {"draw_s": {}}
for a in draw:
    t0 = time.perf_counter()
    params = steps.init_params(get_config(a), 0, "cpu")
    out["draw_s"][a] = time.perf_counter() - t0
    del params
cfg = get_config(arch)
state = steps.init_train_state(cfg, 3, device)
batch = SyntheticLM(DataConfig(cfg.vocab_size, 128, 2, seed=3)).batch_at(0)
state, _ = steps.make_train_step(cfg, adamw.AdamWConfig())(state, batch)  # m, v nonzero
if device.type == "cuda":
    torch.cuda.synchronize()
bucket = Bucket()
t0 = time.perf_counter()
ckpt.save(bucket, "ck", 1, state)
out["save_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
ok = ckpt.is_valid(bucket, "ck", 1)
out["is_valid_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
flat, _ = ckpt.restore(bucket, "ck", 1)
out["restore_s"] = time.perf_counter() - t0
want = tree_flatten_with_paths(state)
out["bytes"] = sum(t.numel() * t.element_size() for _, t in want)
out["blob_bytes"] = sum(map(len, bucket.blobs.values()))
out["bit_equal"] = ok and set(flat) == {p for p, _ in want} and all(
    flat[p].dtype == t.dtype and torch.equal(flat[p], t.cpu()) for p, t in want)
print(json.dumps(out))
"""


def run(tree: Path, args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    res = subprocess.run([sys.executable, "-c", CHILD, args.draw, args.ckpt, args.device],
                         env=env, cwd=tree, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"{tree}: rc {res.returncode}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--draw", default="smollm-360m,qwen2.5-3b")
    ap.add_argument("--ckpt", default="smollm-360m")
    ap.add_argument("--device", default="cuda", help="where the train state lives")
    args = ap.parse_args()
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_host_pools: no CUDA card", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(f"card: {card.strip()}")
    print(f"host cores {os.cpu_count()}")
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {name: [] for name in trees}
    for pair in range(args.pairs):
        for name in (("other", "this") if pair % 2 == 0 else ("this", "other")):
            r = run(trees[name], args)
            runs[name].append(r)
            print(f"{name}: {json.dumps(r)}", flush=True)
    keys = [f"draw_s/{a}" for a in args.draw.split(",")] + ["save_s", "is_valid_s", "restore_s"]

    def get(r, key):
        return r["draw_s"][key.split("/")[1]] if key.startswith("draw_s/") else r[key]

    summary = {name: {k: statistics.median(get(r, k) for r in rs) for k in keys}
               for name, rs in runs.items()}
    print(json.dumps({"median_s": summary}))
    return 0 if all(r["bit_equal"] for rs in runs.values() for r in rs) else 1


if __name__ == "__main__":
    sys.exit(main())
