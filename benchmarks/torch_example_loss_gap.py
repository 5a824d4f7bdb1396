#!/usr/bin/env python3
"""How far the port's ``examples/torch_train_e2e.py`` lands from the
reference's ``examples/train_e2e.py`` on the CPU, against how far a broken
port lands: the readings behind the loss limits of
``tests/test_torch_examples.py``. Run from the root of a checkout:

    PYTHONPATH=src python benchmarks/torch_example_loss_gap.py
        [--seeds 0,1,2] [--steps 30] [--threads 4]

Three readings, each a largest relative gap:

1. The printed losses. For each seed both examples run in-process at
   ``--quick --steps STEPS`` (the port's with ``--device cpu``, both in the
   example's bf16) with the job manifest's train seed set to it, the port
   from the reference's weights for that seed, as in the test; then, at
   the first seed, two broken ports: the optimizer never updating (``lr``
   0) and the learning rate halved.
2. The training's own sensitivity: the reference's jitted steps on the
   example's job in fp32, against the same with every initial param moved
   by 1e-7 relative (a seeded normal draw), at each step up to STEPS.
3. The first FIRST_STEPS straight train steps of the example's job in
   fp32, the port's against the reference's, for each seed; then the two
   broken ports at the first seed.

Needs JAX (the reference), so it runs where the tests run, not on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_examples import (  # noqa: E402
    FIRST_STEPS, load, recording, reference_config, reference_init, split_losses, train_losses)

from repro.models import steps as jsteps  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import steps as tsteps  # noqa: E402

BROKEN = (("lr 0", {"lr": 0.0}), ("lr halved", {"lr": 0.75e-3}))


def with_train(mod, **train):
    """``mod``'s ``JobManifest`` with ``train``'s keys set in every manifest
    it builds."""
    real = mod.JobManifest
    mod.JobManifest = lambda **kw: real(**{**kw, "train": {**kw.get("train", {}), **train}})
    return mod


def transcript(call):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        call()
    return out.getvalue().splitlines()


def printed_gap(ref, port):
    """The largest relative gap of the port's printed losses to the
    reference's, and how many losses were compared."""
    assert len(ref) == len(port), (ref, port)
    gap, n = 0.0, 0
    for a, b in zip(ref, port):
        (text_a, xs), (text_b, ys) = split_losses(a), split_losses(b)
        assert text_a == text_b and len(xs) == len(ys), (a, b)
        for x, y in zip(xs, ys):
            gap, n = max(gap, abs(y - x) / abs(x)), n + 1
    return gap, n


def gaps(want, got):
    return [abs(b - a) / abs(a) for a, b in zip(want, got)]


def perturbed_reference(arch, train, n, rel=1e-7, seed=1):
    """The reference's per-step losses of the job, its initial params each
    moved by ``rel`` times a seeded standard normal draw."""
    cfg = get_tiny_config(arch)
    for k, v in train.get("overrides", {}).items():
        cfg = cfg.replace(**{k: v})
    jcfg = reference_config(cfg)
    state = jsteps.init_train_state(jcfg, jax.random.key(int(train["seed"])))
    rng = np.random.default_rng(seed)
    state = state._replace(params=jax.tree.map(
        lambda x: x * (1 + rel * jnp.asarray(rng.standard_normal(x.shape), x.dtype)),
        state.params))
    step = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(
        lr=train["lr"], warmup_steps=train["warmup"], total_steps=train["steps"])))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=train["seq"],
                                  global_batch=train["batch"], seed=train["seed"]))
    losses = []
    for i in range(n):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
        losses.append(float(metrics["loss"]))
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    tsteps.init_train_state = reference_init
    argv = ["--quick", "--steps", str(args.steps)]
    seeds = [int(s) for s in args.seeds.split(",")]

    def reference(seed):
        sys.argv = ["train_e2e.py", *argv]
        return transcript(with_train(load("train_e2e"), seed=seed).main)

    def port(seed, **train):
        mod = with_train(load("torch_train_e2e"), seed=seed, **train)
        return transcript(lambda: mod.main([*argv, "--device", "cpu"]))

    print("1. printed losses, the example's bf16")
    refs = {seed: reference(seed) for seed in seeds}
    for seed in seeds:
        gap, n = printed_gap(refs[seed], port(seed))
        print(f"  seed {seed}: port, largest relative gap {gap:.3e} over {n} losses")
    for label, train in BROKEN:
        gap, n = printed_gap(refs[seeds[0]], port(seeds[0], **train))
        print(f"  seed {seeds[0]}: broken port ({label}), largest relative gap {gap:.3e} "
              f"over {n} losses")

    manifests = []
    mod = recording(load("torch_train_e2e"), manifests)
    transcript(lambda: mod.main([*argv, "--device", "cpu"]))
    arch, train = manifests[0]["arch"], manifests[0]["train"]
    fp32 = {**train, "overrides": {**train["overrides"], "dtype": "float32"}}

    print("2. the reference against itself, initial params moved by 1e-7 relative, fp32")
    want = train_losses("reference", arch, {**fp32, "seed": seeds[0]}, args.steps)
    got = perturbed_reference(arch, {**fp32, "seed": seeds[0]}, args.steps)
    g = gaps(want, got)
    first = next((i for i, x in enumerate(g) if x > 2e-5), None)
    print(f"  seed {seeds[0]}: step gaps {' '.join(f'{x:.2e}' for x in g)}")
    print(f"  largest {max(g):.3e}; first step over 2e-5: {first}")

    print(f"3. the first {FIRST_STEPS} straight train steps, fp32")
    for seed in seeds:
        job = {**fp32, "seed": seed}
        g = gaps(train_losses("reference", arch, job, FIRST_STEPS),
                 train_losses("port", arch, job, FIRST_STEPS))
        print(f"  seed {seed}: port, largest relative gap {max(g):.3e}")
    job = {**fp32, "seed": seeds[0]}
    want = train_losses("reference", arch, job, FIRST_STEPS)
    for label, train in BROKEN:
        g = gaps(want, train_losses("port", arch, {**job, **train}, FIRST_STEPS))
        print(f"  seed {seeds[0]}: broken port ({label}), largest relative gap {max(g):.3e}")


if __name__ == "__main__":
    main()
