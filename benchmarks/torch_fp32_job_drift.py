#!/usr/bin/env python3
"""How sensitive the fp32 head_dim-256 job of ``chip_smoke.py`` phase 8
(``chip_smoke.FP32_JOB``: recurrentgemma-2b's tiny config, fp32, head_dim
256, 20 steps) is to rounding, on the CPU: the readings behind its 1e-5
limit on the card's per-tick losses and behind its learning rate. Run from
the root of a checkout:

    PYTHONPATH=src python benchmarks/torch_fp32_job_drift.py [--threads 4]

The job's steps run straight, as its learner builds them (the port's
``init_train_state`` of the job's seed, AdamW with its warmup and total
steps, ``SyntheticLM``), without the platform. Two readings, each the
relative gap of the loss at the learner's ticks (steps 4, 9, 14 and 19,
``TorchLearner``'s 5 steps a tick):

1. The training's own sensitivity, at lr 3e-4 (the learner's default) and
   1e-4 (the manifest's): every initial param moved by 1e-7 and by 1e-6
   relative (a seeded normal draw), against the unmoved run.
2. Whether the limit still sees a fault at the manifest's lr: the gradient
   that reaches each attention output scaled by 1.1 and by 1.001 (a hook on
   ``kernels.ops.flash_attention``'s output), against the unbroken run.

Runs on the CPU only: the port's plain versions, no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils.trees import tree_map_with_path  # noqa: E402

TICKS = (4, 9, 14, 19)


def job_losses(lr, nudge=0.0, grad_scale=None):
    """The losses of the job's 20 straight steps at ``lr``, its initial
    params moved by ``nudge`` (relative), the gradient into each attention
    output scaled by ``grad_scale``."""
    job = chip_smoke.FP32_JOB
    cfg = get_tiny_config(chip_smoke.RG_ARCH)
    for k, v in job["overrides"].items():
        cfg = cfg.replace(**{k: v})
    state = steps.init_train_state(cfg, job["seed"], "cpu")
    if nudge:
        gen = torch.Generator().manual_seed(1)
        tree_map_with_path(lambda _, t: t.mul_(1 + nudge * torch.randn(t.shape, generator=gen)),
                           state.params)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=lr, warmup_steps=10,
                                                        total_steps=job["steps"]))
    data = SyntheticLM(DataConfig(cfg.vocab_size, job["seq"], job["batch"], seed=job["seed"]))
    flash = ops.flash_attention

    def scaled(*args, **kwargs):
        out = flash(*args, **kwargs)
        if out.requires_grad:
            out.register_hook(lambda g: g * grad_scale)
        return out

    if grad_scale is not None:
        ops.flash_attention = scaled
    try:
        losses = []
        for i in range(job["steps"]):
            state, metrics = step(state, data.batch_at(i))
            losses.append(float(metrics["loss"]))
    finally:
        ops.flash_attention = flash
    return losses


def gaps(got, want):
    return ", ".join(f"step {i} {abs(got[i] - want[i]) / abs(want[i]):.2e}" for i in TICKS)


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    for lr in (3e-4, 1e-4):
        base = job_losses(lr)
        for nudge in (1e-7, 1e-6):
            print(f"lr {lr:g}, initial params moved by {nudge:g}: "
                  f"{gaps(job_losses(lr, nudge=nudge), base)}")
        if lr == chip_smoke.FP32_JOB["lr"]:
            for scale in (1.1, 1.001):
                print(f"lr {lr:g}, attention output gradient x {scale:g}: "
                      f"{gaps(job_losses(lr, grad_scale=scale), base)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
