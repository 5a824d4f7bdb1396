"""Sizing on four cards: the dry-run (``repro_torch.launch.dryrun.run_cell``)
of the archs too large to train on one 80 GB H100, at the card's train
shape (B8 x S512, bf16, remat full), on meshes of 1, 2x2, 1x4 and 4x1
devices, and their prefill of B8 x S512 on one card. It prints each cell's
per-device peak against 80 GB and writes them all as JSON.

Everything runs on the CPU on meta tensors (fake process groups, no card):
the peaks are the port's own count of live storage on one rank
(``launch.op_cost``), which ``chip_smoke.py``'s dry-run phase holds to the
card's ``max_memory_allocated`` on four smaller archs.

Usage (from the repo root):
  PYTHONPATH=src python benchmarks/torch_dryrun_fit.py [--out experiments/dryrun_fit.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import ShapeConfig
from repro_torch.launch.dryrun import HBM_BYTES, run_cell

ARCHS = ("llama3-8b", "deepseek-coder-33b", "chameleon-34b", "qwen3-moe-235b-a22b")
MESHES = ((), (2, 2), (1, 4), (4, 1))
TRAIN = ShapeConfig("train_b8_s512", 512, 8, "train")
PREFILL = ShapeConfig("prefill_b8_s512", 512, 8, "prefill")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="experiments/dryrun_fit.json")
    args = ap.parse_args()
    rows = []
    cells = [(arch, TRAIN, mesh) for arch in ARCHS for mesh in MESHES] + \
        [(arch, PREFILL, ()) for arch in ARCHS]
    t_all = time.time()
    for arch, shape, mesh in cells:
        res = run_cell(arch, shape=shape, mesh_shape=mesh)
        rows.append(res)
        print(f"{arch:22s} {shape.kind:8s} mesh {res['mesh']:5s}: peak "
              f"{res['peak_bytes'] / 1e9:9.2f} GB a device (inputs {res['arg_bytes'] / 1e9:9.2f} "
              f"GB), {'fits' if res['fits_80gb'] else 'does not fit'} 80 GB; "
              f"{res['flops_per_device']:.4e} FLOP, {res['collective_bytes_per_device'] / 1e9:.3f}"
              f" GB of collectives; traced in {res['trace_s']} s", flush=True)
    print(f"{len(cells)} cells in {time.time() - t_all:.1f} s (host wall, CPU)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"hbm_bytes": HBM_BYTES, "cells": rows}, f, indent=1)


if __name__ == "__main__":
    main()
