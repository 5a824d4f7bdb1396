"""Dry-run and cost cases that need a fake process group, run in a process
of their own (the default group is process-wide, and a test process may
hold none): ``tests/test_torch_dryrun.py`` and ``tests/test_torch_op_cost.py``
start it with the cases they want and read its JSON.

Usage: python tests/_torch_dryrun_worker.py OUT.json CASE [CASE ...]

Cases (fields separated by ':'):
  arg_bytes:ARCH:sp|mp      the rank's bytes of train_4k's placed inputs
  tiny:ARCH:KIND:MESH       run_cell of the arch's tiny config, B4 x S32,
                            on a fake MESH (2x2, 2x2x2)
  full:ARCH:SHAPE:sp|mp     run_cell at full width on a production mesh
  collective_loop           10 all-reduces of a (16, 16) fp32 in a loop
  column_split              a product with its columns split 4 ways
  cli                       the CLI on whisper-tiny decode_32k, single pod
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
import time
import traceback

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs import ShapeConfig, get_tiny_config
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import make_env, make_fake_mesh
from repro_torch.parallel import use_env

KEEP = ("mesh", "n_chips", "kind", "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collectives", "collective_counts", "arg_bytes",
        "output_bytes", "peak_bytes", "fits_80gb", "kernels", "loops", "bottleneck",
        "useful_flops_ratio", "model_flops_global")


def _finite(res: dict) -> bool:
    return all(math.isfinite(v) for v in res.values() if isinstance(v, float))


def arg_bytes(arch, mesh):
    env = make_env(make_fake_mesh(*dryrun.PRODUCTION_MESHES[mesh == "mp"]))
    with use_env(env):
        _, args, _ = dryrun.build_cell(arch, "train_4k", env)
        return op_cost.local_bytes(args)


def tiny(arch, kind, mesh):
    res = dryrun.run_cell(arch, shape=ShapeConfig(f"tiny_{kind}", 32, 4, kind),
                          mesh_shape=tuple(int(x) for x in mesh.split("x")),
                          overrides=dataclasses.asdict(get_tiny_config(arch)))
    return {**{k: res[k] for k in KEEP}, "finite": _finite(res)}


def full(arch, shape, mesh):
    res = dryrun.run_cell(arch, shape, multi_pod=mesh == "mp")
    return {**{k: res[k] for k in KEEP}, "finite": _finite(res)}


def collective_loop():
    mesh = make_fake_mesh((1, 4), ("data", "model"))
    x = DTensor.from_local(torch.empty(16, 16, device="meta"), mesh, (Replicate(), Partial()),
                           run_check=False, shape=(16, 16), stride=(16, 1))

    def loop(x):
        for _ in range(10):
            x.redistribute(mesh, (Replicate(), Replicate()))

    return op_cost.analyze(loop, x)


def column_split():
    mesh = make_fake_mesh((1, 4), ("data", "model"))
    x = DTensor.from_local(torch.empty(64, 256, device="meta"), mesh, (Replicate(), Replicate()),
                           run_check=False, shape=(64, 256), stride=(256, 1))
    w = DTensor.from_local(torch.empty(256, 128, device="meta"), mesh, (Replicate(), Shard(1)),
                           run_check=False, shape=(256, 512), stride=(512, 1))
    return op_cost.analyze(lambda x, w: x @ w, x, w)


def cli():
    with tempfile.TemporaryDirectory() as out:
        dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out", out])
        names = os.listdir(out)
        with open(os.path.join(out, names[0])) as f:
            return {"files": names, "result": json.load(f)}


CASES = {"arg_bytes": arg_bytes, "tiny": tiny, "full": full,
         "collective_loop": collective_loop, "column_split": column_split, "cli": cli}


def spawn(cases, out_dir, jobs=1, timeout=240) -> dict:
    """Run ``cases`` in ``jobs`` worker processes at once (the cases dealt
    out in turn), all killed ``timeout`` seconds after the start; returns
    {case: result}. A case whose process died or ran out of time is
    missing."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = []
    for j in range(jobs):
        out = os.path.join(out_dir, f"dryrun{j}.json")
        procs.append((out, subprocess.Popen([sys.executable, os.path.abspath(__file__), out,
                                             *cases[j::jobs]], env=env,
                                            stdout=subprocess.DEVNULL,
                                            stderr=subprocess.DEVNULL)))
    deadline = time.monotonic() + timeout
    results = {}
    for out, p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if os.path.exists(out):
            with open(out) as f:
                part = json.load(f)
            results.update(part)
            results["seconds"] = {**results.get("seconds", {}), **part.get("seconds", {})}
    return results


def main():
    out_path, cases = sys.argv[1], sys.argv[2:]
    results, seconds = {}, {}
    for case in cases:
        name, *fields = case.split(":")
        t0 = time.perf_counter()
        try:
            results[case] = CASES[name](*fields)
        except Exception:  # each case reports its own failure; the others go on
            results[case] = {"error": traceback.format_exc()}
        seconds[case] = time.perf_counter() - t0
        results["seconds"] = seconds
        with open(out_path, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    main()
