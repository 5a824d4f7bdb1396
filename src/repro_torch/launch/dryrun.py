"""The dry-run: every (arch x shape) cell traced through the port's own step
functions on the CPU, with no card and no allocation (the reference's
``repro/launch/dryrun.py``).

One process holds a fake process group of 512 ranks and is rank 0 of it;
a cell's mesh is 16x16 (``data, model``) over its first 256 ranks or
2x16x16 (``pod, data, model``) over all 512 (``launch.mesh.make_fake_mesh``).
Every leaf of a cell's inputs is a DTensor over an empty meta local shard,
placed as the reference places it (``parallel.sharding.place_abstract``):
the params by their logical axes, the optimizer state by ZeRO-1, the batch
by ``batch``, a decode state by its state axes. The step runs on them as it
runs on the card: DTensor's sharding propagation, the redistributions and
their collectives (which move nothing), the kernels' shape functions on
each rank's local shards (``kernels.ops``). ``launch.op_cost`` counts what
rank 0 executes, forward, backward and update: its FLOPs, bytes and
collective bytes, and the high-water mark of its live storage, checked
against one H100's 80 GB.

The JSON keys are the reference's, so the two runs read side by side, with
these changes: ``compile_s`` is ``trace_s`` (the port traces, it compiles
nothing), the ``xla_*_raw`` keys are gone, and ``peak_bytes``,
``fits_80gb``, ``kernels`` (the hand-written kernels' calls, FLOPs and
bytes) and ``loops`` (the sLSTM's time loop, counted on meta as one
measured step times its steps: ``nn.recurrent``) are added. ``arg_bytes`` is the rank's shards of the inputs,
``output_bytes`` those of the outputs (the donated train state's included,
as XLA's output size includes an aliased output), ``temp_bytes`` the peak
beyond the inputs. The roofline terms use the H100 data-sheet constants of
``launch.mesh`` (not measurements): NVLink's rate for the collectives on up
to 8 devices, the network's beyond.

A decode cell writes its token at ``cache_len`` = the cache's capacity
minus 1, the last slot: the write lands inside a ``compact`` cache (a local
window's, bounded at window + 1, where the reference lowers a clamped
write), and decode attention costs the same at every ``cache_len`` (it
scores the whole cache, masked).

``--bf16-interior`` is accepted for the reference's command lines: the
port's interior products always emit their operands' dtype
(``nn/policy.py``), which is what that option selects in the reference.

Usage (from the repo root; cells as the reference's ``all_cells``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, ShapeConfig, all_cells, get_config
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import (
    HBM_BW,
    PEAK_FLOPS_BF16,
    PRODUCTION_MESHES,
    collective_bw,
    make_env,
    make_fake_mesh,
)
from repro_torch.models import steps
from repro_torch.models.steps import TrainState
from repro_torch.optim import adamw
from repro_torch.parallel import logical_to_spec, param_shardings, use_env
from repro_torch.parallel.sharding import NamedSharding, P, null_env, place_abstract
from repro_torch.parallel.zero import opt_state_shardings
from repro_torch.utils.trees import tree_bytes, tree_flatten_with_paths

HBM_BYTES = 80e9  # one H100's device memory (data sheet)
OUT_DIR = "experiments/dryrun_torch"


def _shardings(env, make):
    """``make()``'s shardings under an active env; None (a plain meta tensor
    at every leaf) with no mesh."""
    return make() if env.active else None


def build_cell(arch: str, shape, env, remat=None, overrides=None):
    """(fn, args, cfg): a cell's step function and its inputs, each leaf a
    DTensor over an empty meta local shard placed on ``env``'s mesh as the
    reference places it (a plain meta tensor with no mesh). ``shape`` is a
    name of ``SHAPES`` or a ``ShapeConfig``."""
    cfg = get_config(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = env.mesh
    aparams = steps.abstract_params(cfg)
    paxes = steps.param_axes(cfg)
    pshard = _shardings(env, lambda: param_shardings(paxes, aparams, env))
    specs = steps.input_specs(cfg, shape)

    def batch_shardings(batch):
        axes = {k: ("batch",) + (None,) * (len(v.shape) - 1) for k, v in batch.items()}
        return {k: NamedSharding(mesh, logical_to_spec(axes[k], env, v.shape))
                for k, v in batch.items()}

    if shape.kind in ("train", "prefill"):
        batch = place_abstract(specs["batch"], _shardings(env, lambda: batch_shardings(specs["batch"])))
    if shape.kind == "train":
        fn = steps.make_train_step(cfg, adamw.AdamWConfig(total_steps=10000))
        st_shard = _shardings(env, lambda: TrainState(
            NamedSharding(mesh, P()), pshard, opt_state_shardings(paxes, aparams, env)))
        return fn, (place_abstract(steps.abstract_train_state(cfg), st_shard), batch), cfg
    if shape.kind == "prefill":
        return steps.make_prefill_step(cfg), (place_abstract(aparams, pshard), batch), cfg

    fn = steps.make_decode_step(cfg)
    saxes = steps.decode_state_axes(cfg)
    states = place_abstract(specs["states"], _shardings(
        env, lambda: param_shardings(saxes, specs["states"], env)))
    token = place_abstract({"t": specs["token"]}, _shardings(env, lambda: batch_shardings(
        {"t": specs["token"]})))["t"]
    capacity = min(t.shape[-2] for path, t in tree_flatten_with_paths(specs["states"])
                   if "cross_kv" not in path and len(t.shape) >= 4)
    return fn, (place_abstract(aparams, pshard), token, states, capacity - 1), cfg


def _mesh_name(mesh_shape) -> str:
    return "x".join(str(n) for n in mesh_shape) if mesh_shape else "1"


def run_cell(arch: str, shape_name: str | None = None, multi_pod: bool = False,
             remat=None, overrides=None, rule_overrides=None,
             bf16_interior: bool = False, *, shape: ShapeConfig | None = None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell traced and counted on rank 0 (module doc). ``shape`` (a
    ``ShapeConfig``) stands in for ``shape_name``; ``mesh_shape`` for the
    production mesh: () is one device with no mesh, (D, M) a (data, model)
    mesh of D·M fake ranks, (P, D, M) a (pod, data, model) one."""
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        dims, axes = PRODUCTION_MESHES[multi_pod]
    else:
        dims = tuple(mesh_shape)
        axes = ("pod", "data", "model")[3 - len(dims):] if dims else ()
    n_chips = 1
    for d in dims:
        n_chips *= d
    t0 = time.time()
    if dims:
        env = make_env(make_fake_mesh(dims, axes), overrides=rule_overrides)
    else:
        env = null_env()
    with use_env(env):
        fn, args, cfg = build_cell(arch, shape, env, remat=remat, overrides=overrides)
        cost = op_cost.analyze(fn, *args)
    t_trace = time.time() - t0

    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    flops_pd, bytes_pd = cost["flops"], cost["bytes"]
    coll_pd = cost["collective_bytes"]
    terms = {"compute_s": flops_pd / PEAK_FLOPS_BF16, "memory_s": bytes_pd / HBM_BW,
             "collective_s": coll_pd / collective_bw(n_chips)}
    bottleneck = max(terms, key=terms.get)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": _mesh_name(dims),
        "n_chips": n_chips,
        "kind": shape.kind,
        "trace_s": round(t_trace, 1),
        "flops_per_device": flops_pd,
        "bytes_per_device": bytes_pd,
        "collective_bytes_per_device": coll_pd,
        "collectives": cost["collectives"],
        "collective_counts": cost["collective_counts"],
        "kernels": cost["kernels"],
        "loops": cost["loops"],
        "param_bytes_global": tree_bytes(steps.abstract_params(cfg)),
        "n_params": cfg.param_count(),
        "n_active_params": n_active,
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / max(flops_pd * n_chips, 1),
        **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "arg_bytes": cost["arg_bytes"],
        "temp_bytes": cost["peak_bytes"] - cost["arg_bytes"],
        "output_bytes": cost["output_bytes"],
        "peak_bytes": cost["peak_bytes"],
        "fits_80gb": cost["peak_bytes"] <= HBM_BYTES,
        "remat": cfg.remat,
        "bf16_interior": bf16_interior,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--bf16-interior", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.time()
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
            if args.tag:
                tag += f"__{args.tag}"
            try:
                res = run_cell(arch, shape, multi_pod=mp, remat=args.remat,
                               bf16_interior=args.bf16_interior)
                with open(f"{args.out}/{tag}.json", "w") as f:
                    json.dump(res, f, indent=1)
                print(f"OK   {tag:60s} trace={res['trace_s']:6.1f}s "
                      f"bottleneck={res['bottleneck']:10s} "
                      f"compute={res['compute_s']*1e3:9.2f}ms "
                      f"mem={res['memory_s']*1e3:9.2f}ms "
                      f"coll={res['collective_s']*1e3:9.2f}ms "
                      f"peak={res['peak_bytes']/1e9:8.2f}GB", flush=True)
            except Exception as e:  # a cell's failure is reported; the sweep goes on
                failures.append(tag)
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    print(f"\nsweep of {len(cells) * len(meshes)} cells: {time.time() - t_all:.1f} s "
          f"(host wall, torch {torch.__version__})")
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
