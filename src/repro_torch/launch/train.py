"""Training launcher of the port, on one device or on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --tiny \\
        --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/run1 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
        --tiny --steps 6 --batch 2 --seq 32 --ckpt-dir /tmp/run3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --tiny \\
        --device cpu --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 20 --batch 8 --seq 512
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --tiny --mesh 2x2 --device cpu --steps 6 --batch 4 --seq 32

It trains any of the nine ported archs: smollm-360m, recurrentgemma-2b,
xlstm-125m, llama3-8b, deepseek-coder-33b, qwen2.5-3b, chameleon-34b,
granite-moe-3b-a800m and qwen3-moe-235b-a22b (``--tiny`` for their reduced
configs, which run on the CPU). On one card (80 GB) the full widths of
smollm-360m, recurrentgemma-2b, xlstm-125m, qwen2.5-3b and
granite-moe-3b-a800m train at B8 S512; the others' train states (about 16
bytes a param) do not fit one card (their sharded runs wait for ROADMAP
A.14's fit check and a four-card cell). An MoE arch's loss adds its
load-balancing aux, weighted 0.01.

The reference's ``repro/launch/train.py`` on one device: it builds the
train state, resumes from the newest valid checkpoint in ``--ckpt-dir`` if
there is one, then runs the step loop with asynchronous checkpoints and
prints ``step … loss … gnorm … lr … tok/s`` every ``--log-every`` steps.
It runs on the card (``--device cuda``, the default) unless asked for the
CPU.

``--mesh DxM`` trains on a (data, model) mesh of D*M processes, one a
device (``torchrun --nproc-per-node D*M``, or one process with ``1x1``):
the params placed by their logical axes, the optimizer state by ZeRO-1,
the batch split over ``data`` (``parallel``), as the reference's CLI
shards its jitted step. ``--sp`` shards the residual stream's sequence
over ``model`` (``seq`` → ``model``), ``--batch-tp`` the attention's batch
over both axes (``batch_attn`` → ``(data, model)``); with no mesh they do
nothing, as in the reference. Checkpoints are whole (``ckpt.checkpoint``),
so a run resumes on another mesh, or none. Rank 0 prints.

On the card the step is made deterministic (``deterministic``): the same
seed gives the same parameters bit for bit, and a run resumed from a
checkpoint ends where an uninterrupted one does.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.objectstore import DirBucket
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import mesh_env
from repro_torch.launch.serve import resolve_device
from repro_torch.models import steps
from repro_torch.optim import adamw
from repro_torch.parallel import use_env
from repro_torch.utils.trees import tree_flatten_with_paths


def deterministic(device: torch.device):
    """On the card, deterministic kernels only: cuBLAS with a fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG``, read when cuBLAS first runs in
    the process, so this is called before any product) and
    ``torch.use_deterministic_algorithms``, under which an op with no
    deterministic kernel raises. The port's own kernels are deterministic
    by design. The CPU's kernels are deterministic as they are."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        # nn/policy.py: interior products accumulate in fp32.
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="use the reduced smoke config of the family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--mesh", default="1", help="e.g. 2x2 = data x model")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--batch-tp", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    deterministic(device)
    overrides = {}
    if args.sp:
        overrides["seq"] = "model"
    if args.batch_tp:
        overrides["batch_attn"] = ("data", "model")
    env, device = mesh_env(args.mesh, device, overrides)
    rank0 = not env.active or torch.distributed.get_rank() == 0
    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    cfg = cfg.replace(remat=args.remat)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))
    bucket = DirBucket(args.ckpt_dir) if args.ckpt_dir else None
    acp = ckpt.AsyncCheckpointer(bucket, "ckpt") if bucket else None
    with use_env(env):
        train_step = steps.make_train_step(cfg, opt_cfg)
        st_sh = steps.train_state_shardings(cfg, env) if env.active else None

        # resume from the newest valid checkpoint (the platform learner's contract)
        start = 0
        if bucket is not None:
            latest = ckpt.latest_step(bucket, "ckpt")
            if latest is not None:
                if env.active:
                    state, _ = ckpt.restore(bucket, "ckpt", latest,
                                            like=steps.abstract_train_state(cfg),
                                            shardings=st_sh)
                else:
                    flat, _ = ckpt.restore(bucket, "ckpt", latest)
                    state = train_state_from_numpy(flat, cfg, device)
                start = latest
                if rank0:
                    print(f"resumed from checkpoint step {latest}")
        if start == 0:
            state = steps.init_train_state(cfg, args.seed, device)
            if env.active:
                state = steps.place_tree(state, st_sh)

        n_params = sum(t.numel() for _, t in tree_flatten_with_paths(state.params))
        if rank0:
            print(f"arch={cfg.name} params={n_params / 1e6:.1f}M mesh={args.mesh} "
                  f"device={device}")

        t0 = time.perf_counter()
        tokens_done = 0
        for step in range(start, args.steps):
            state, metrics = train_step(state, shard_batch(data.batch_at(step), env, device))
            tokens_done += args.batch * args.seq
            if (step + 1) % args.log_every == 0 and rank0:
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                print(f"step {step + 1:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{tokens_done / dt:,.0f} tok/s")
            if acp is not None and (step + 1) % args.ckpt_every == 0:
                acp.save(step + 1, state, {"loss": float(metrics["loss"])})
        if acp is not None:
            acp.save(args.steps, state, {"final": True})
            acp.wait()
            if rank0:
                print(f"checkpoints: {ckpt.steps_available(bucket, 'ckpt')}")
    return state


if __name__ == "__main__":
    main()
