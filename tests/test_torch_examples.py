"""The port's examples (``examples/torch_*.py``) against the reference's on
the CPU.

Each port example runs in-process with ``--device cpu`` beside the
reference's example of the same name: both submit equal job manifests, and
their transcripts are equal line for line (each example asserts its own
outcome: every job COMPLETED, and so on). The real jobs of both start from
the same weights: the port's ``init_train_state`` is swapped, here, for
the reference's init of the same config and seed, loaded through
``repro_torch.convert.train_state_from_numpy``. ``multi_tenant --http``
prints its server's ephemeral port, which compares as a placeholder.
``train_e2e`` runs at ``--quick --steps 30`` on both packages (its HALT
at step 10, one checkpoint with a loss, at step 25). The real jobs run
with one intra-op thread.

The printed losses compare within LOSS_REL (5e-3 relative, twice the
largest honest reading), which only a gross fault exceeds: the tiny
smollm's training is too sensitive for a tight limit at step 25. The
reference against itself, its initial params moved by 1e-7 relative,
passes 2e-5 apart at step 10 and lands up to 1.4e-3 apart within 30 steps
in fp32; the port against the reference printed 1.8e-4 to 2.5e-3 at step
25 (5 seeds, the example's bf16), and a port whose optimizer never updates
3.95e-3 (benchmarks/torch_example_loss_gap.py; PERF.md keeps the
readings). So ``test_train_e2e_trail_is_its_jobs_replay`` holds the loss
precisely instead: the port's printed checkpoint loss is, bit for bit,
that of the port's straight train steps on the job's manifest, and those
steps hold to the reference's within FP32_REL (2e-5 relative) over their
first FIRST_STEPS steps in fp32, before the sensitivity sets in (the port
read at most 4.3e-7 there over 5 seeds; a port with its learning rate at
0 reads 1.3e-3 and with it halved 4.6e-4).

Without ``--device cpu`` and without a card, each port example raises
before it builds a platform.
"""

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mirror import one_thread  # noqa: F401 (a fixture)

from repro.configs import base as rbase
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro.utils import tree_flatten_with_paths as jflatten
from repro_torch.configs import get_tiny_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import steps as tsteps
from repro_torch.optim import adamw as tadamw

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CASES = [("quickstart", []), ("multi_tenant", []), ("multi_tenant", ["--http"]),
         ("pipeline_e2e", []), ("chaos_drill", []), ("train_e2e", ["--quick", "--steps", "30"])]
LOSS = re.compile(r"(loss(?: decreased)? )(\d+\.\d+)(?: -> (\d+\.\d+))?")
ENDPOINT = re.compile(r"http://127\.0\.0\.1:\d+")
LOSS_REL = 5e-3
FP32_REL = 2e-5
FIRST_STEPS = 6


def load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording(mod, manifests):
    """``mod`` with every ``JobManifest`` it builds appended to
    ``manifests`` as a dict."""
    real = getattr(mod, "JobManifest", None)
    if real is not None:
        def manifest(*args, **kwargs):
            m = real(*args, **kwargs)
            manifests.append(dataclasses.asdict(m))
            return m
        mod.JobManifest = manifest
    return mod


def reference_config(cfg):
    return rbase.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def reference_init(cfg, seed, device="cpu"):
    """The reference's ``init_train_state`` of the port's config, as a port
    train state."""
    state = jsteps.init_train_state(reference_config(cfg), jax.random.key(seed))
    return train_state_from_numpy({p: np.asarray(x) for p, x in jflatten(state)}, cfg, device)


def train_losses(package, arch, train, n):
    """The losses of ``n`` straight train steps of the job whose manifest
    has ``arch`` and ``train``, as both learners build it (the tiny config
    with the overrides, AdamW, the synthetic stream), from the reference's
    init of its seed: the reference's jitted step (``package``
    "reference") or the port's ("port")."""
    cfg = get_tiny_config(arch)
    for k, v in train.get("overrides", {}).items():
        cfg = cfg.replace(**{k: v})
    opt = dict(lr=train.get("lr", 3e-4), warmup_steps=train.get("warmup", 10),
               total_steps=int(train.get("steps", 100)))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=train.get("seq", 128),
                                  global_batch=train.get("batch", 8), seed=train.get("seed", 0)))
    seed = int(train.get("seed", 0))
    if package == "reference":
        jcfg = reference_config(cfg)
        state = jsteps.init_train_state(jcfg, jax.random.key(seed))
        step = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))
    else:
        state = reference_init(cfg, seed)
        step = tsteps.make_train_step(cfg, tadamw.AdamWConfig(**opt))
    losses = []
    for i in range(n):
        batch = data.batch_at(i)
        if package == "reference":
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def transcripts(name, args, monkeypatch, capsys):
    """(reference lines, port lines, reference manifests, port manifests)
    of one example."""
    ref_manifests, port_manifests = [], []
    ref = recording(load(name), ref_manifests)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    capsys.readouterr()
    ref.main()
    ref_out = capsys.readouterr().out
    port = recording(load(f"torch_{name}"), port_manifests)
    monkeypatch.setattr(tsteps, "init_train_state", reference_init)
    port.main([*args, "--device", "cpu"])
    port_out = capsys.readouterr().out
    return ref_out.splitlines(), port_out.splitlines(), ref_manifests, port_manifests


def split_losses(line):
    """A line with its printed losses taken out: (the line with each loss as
    a placeholder, [losses])."""
    losses = [float(x) for m in LOSS.finditer(line) for x in m.groups()[1:] if x is not None]
    return LOSS.sub(lambda m: m.group(1) + "<loss>" + (" -> <loss>" if m.group(3) else ""),
                    ENDPOINT.sub("http://127.0.0.1:<port>", line)), losses


@pytest.mark.parametrize("name,args", CASES, ids=[" ".join([n, *a]) for n, a in CASES])
def test_transcript_equals_the_reference(name, args, one_thread, monkeypatch, capsys):
    ref, port, ref_manifests, port_manifests = transcripts(name, args, monkeypatch, capsys)
    assert ref, "the reference example printed nothing"
    assert port_manifests == ref_manifests
    assert len(port) == len(ref)
    n_losses = 0
    for i, (a, b) in enumerate(zip(ref, port)):
        (text_a, losses_a), (text_b, losses_b) = split_losses(a), split_losses(b)
        assert text_b == text_a, (i, a, b)
        assert len(losses_b) == len(losses_a)
        for x, y in zip(losses_a, losses_b):
            assert abs(y - x) <= LOSS_REL * abs(x), (i, a, b)
        n_losses += len(losses_a)
    assert (n_losses > 0) == (name == "train_e2e")


def test_train_e2e_trail_is_its_jobs_replay(one_thread, monkeypatch):
    """The loss of the port's ``train_e2e --quick --steps 30`` job at its
    step-25 checkpoint is, bit for bit, that of 25 straight port train
    steps on the job's manifest: HALT, RESUME and the checkpoint round trip
    change nothing. The same steps in fp32 hold to the reference's jitted
    steps within FP32_REL over the first FIRST_STEPS (the module docstring
    says why no later ones)."""
    manifests = []
    port = recording(load("torch_train_e2e"), manifests)
    monkeypatch.setattr(tsteps, "init_train_state", reference_init)
    result = port.main(["--quick", "--steps", "30", "--device", "cpu"])
    (manifest,) = manifests
    arch, train = manifest["arch"], manifest["train"]
    assert [s for s, _ in result["trail"]] == [25]
    assert result["trail"][0][1] == train_losses("port", arch, train, 25)[24]
    fp32 = {**train, "overrides": {**train["overrides"], "dtype": "float32"}}
    want = train_losses("reference", arch, fp32, FIRST_STEPS)
    got = train_losses("port", arch, fp32, FIRST_STEPS)
    assert len(set(want)) == FIRST_STEPS
    for i, (a, b) in enumerate(zip(want, got)):
        assert abs(b - a) <= FP32_REL * abs(a), (i, want, got)


@pytest.mark.parametrize("name", sorted({n for n, _ in CASES}))
def test_without_a_card_the_example_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this checks the path taken where no card is present")
    with pytest.raises(RuntimeError, match="runs on a CUDA card by default"):
        load(f"torch_{name}").main([])
