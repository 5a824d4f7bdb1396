#!/usr/bin/env python3
"""The port's train and serve CLIs on meshes of four NVIDIA H100s over
NCCL, held to the same runs on one card. Run from the root of a checkout,
one process a card:

    torchrun --nproc-per-node 4 benchmarks/torch_mesh_nccl.py

Every rank runs each case through its CLI's ``main`` in one process group
(tiny configs, the config's dtype, seed 0; train: 4 steps of B8 x S64,
each step's loss logged; serve: 4 requests of 24 tokens, 8 generated).
A rank whose case raises prints the traceback and exits at once, so that
the launcher ends the others rather than leave them waiting in a
collective. After the last case the group is closed and rank 0 runs every
case again with no mesh, on its card. Rank 0 prints each case's losses or
tokens beside the one-card run's and a JSON line; the exit code is
non-zero where a case raised or a loss differs from the one-card run's by
more than 2e-2 relative (bf16: the train step's tolerance). Greedy bf16
tokens are printed, not held: a near tie may part them.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

TRAIN = ["--tiny", "--steps", "4", "--log-every", "1", "--batch", "8", "--seq", "64"]
SERVE = ["--tiny", "--requests", "4", "--prompt-len", "24", "--gen", "8"]
CASES = [  # (name, CLI, arch, mesh options)
    ("qwen2.5 2x2", "train", "qwen2.5-3b", ["--mesh", "2x2"]),
    ("qwen2.5 1x4 (q heads split, kv whole)", "train", "qwen2.5-3b", ["--mesh", "1x4"]),
    ("granite 2x2 (token-parallel MoE)", "train", "granite-moe-3b-a800m", ["--mesh", "2x2"]),
    ("qwen3-moe 2x2 (expert-parallel MoE)", "train", "qwen3-moe-235b-a22b", ["--mesh", "2x2"]),
    ("smollm 2x2 --sp", "train", "smollm-360m", ["--mesh", "2x2", "--sp"]),
    ("smollm 2x2 --batch-tp", "train", "smollm-360m", ["--mesh", "2x2", "--batch-tp"]),
    ("recurrentgemma 2x2 --sp", "train", "recurrentgemma-2b", ["--mesh", "2x2", "--sp"]),
    ("serve qwen2.5 2x2", "serve", "qwen2.5-3b", ["--mesh", "2x2"]),
    ("serve qwen2.5 2x2 --ctx-parallel", "serve", "qwen2.5-3b",
     ["--mesh", "2x2", "--ctx-parallel"]),
    ("serve recurrentgemma 2x2 --ctx-parallel", "serve", "recurrentgemma-2b",
     ["--mesh", "2x2", "--ctx-parallel"]),
]
TOL = 2e-2


def run(cli: str, argv: list) -> dict:
    """One CLI run; its printed losses (train) or tokens (serve)."""
    from repro_torch.launch import serve, train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        (train if cli == "train" else serve).main(argv)
    text = out.getvalue()
    if cli == "train":
        return {"losses": [float(x) for x in re.findall(r"loss (\S+)", text)]}
    found = re.search(r"sample continuation \(req 0\): (\[.*\])", text)
    return {"tokens": json.loads(found.group(1)) if found else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import init_process_group
    world = init_process_group("cuda")
    rank = dist.get_rank()
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())
        print(f"torch {torch.__version__}, backend {dist.get_backend()}, world {world}",
              flush=True)
    got = {}
    for name, cli, arch, opts in CASES:
        try:
            got[name] = run(cli, ["--arch", arch] + (TRAIN if cli == "train" else SERVE) + opts)
        except BaseException:
            print(f"rank {rank}, {name}: raised\n{traceback.format_exc()}", flush=True)
            os._exit(1)
        if rank == 0:
            print(f"{name}: {got[name]}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return 0
    bad, rows = [], {}
    for name, cli, arch, _ in CASES:
        one = run(cli, ["--arch", arch] + (TRAIN if cli == "train" else SERVE))
        row = {"mesh": got[name], "one_card": one}
        if cli == "train":
            a, b = got[name]["losses"], one["losses"]
            rel = max(abs(x - y) / abs(y) for x, y in zip(a, b)) if a and len(a) == len(b) else None
            row["max_rel_diff"] = rel
            if rel is None or rel > TOL:
                bad.append(name)
            note = f"losses {a} against one card's {b}: max relative difference {rel}"
        else:
            row["tokens_equal"] = got[name]["tokens"] == one["tokens"]
            note = (f"tokens {got[name]['tokens']} against one card's {one['tokens']}: "
                    f"{'equal' if row['tokens_equal'] else 'differ'}")
        rows[name] = row
        print(f"{name}: {note}", flush=True)
    print(json.dumps({"world": world, "cases": rows, "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
