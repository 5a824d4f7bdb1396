"""The port's learner (repro_torch.core.executor.TorchLearner) through the
platform, and the port's train CLI, on the CPU.

The guardian builds each learner with ``make_learner``
(src/repro/core/guardian.py); a scoped monkeypatch makes it build the
port's ``TorchLearner`` for jobs with an arch and the reference's own
learner otherwise. These are the port's analogues of
tests/test_recovery_determinism.py: a crashed job resumes from its
checkpoint to the same final parameters, bit for bit, and the synthetic
task is learnable through the platform.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_mirror import one_thread  # noqa: F401 (a fixture)

from repro.api import ApiClient
from repro.core import FfDLPlatform, JobManifest, JobStatus
from repro.core import executor as jexecutor
from repro.core import guardian
from repro.core.types import EventLog
from repro.data.objectstore import ObjectStore

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.executor import TorchLearner
from repro_torch.data.objectstore import DirBucket, MountedBucket
from repro_torch.launch import train as train_cli



@pytest.fixture
def torch_learners(monkeypatch, one_thread):
    """Swap the port's learner into the guardian (its real jobs on one
    intra-op thread); yields a function that sets the device and returns
    the list of learners built so far."""
    built, device = [], {"name": "cpu"}

    def make_learner(ctx):
        if ctx.manifest.arch is None:
            return jexecutor.make_learner(ctx)
        learner = TorchLearner(ctx, device=device["name"])
        built.append(learner)
        return learner

    monkeypatch.setattr(guardian, "make_learner", make_learner)

    def use(name):
        device["name"] = name
        return built

    return use


def run_job(crash_at_step=None, steps=60, ckpt_every=20):
    p = FfDLPlatform(n_hosts=2, chips_per_host=4)
    c = ApiClient.for_platform(p)
    j = c.submit(JobManifest(
        name="det", arch="smollm-360m", n_learners=1, chips_per_learner=2,
        checkpoint_interval=ckpt_every,
        train={"steps": steps, "batch": 4, "seq": 64, "seed": 3}))
    crashed = False
    for _ in range(3000):
        p.tick()
        rec = p.meta.get(j)
        if rec.status in (JobStatus.COMPLETED, JobStatus.FAILED):
            break
        if (crash_at_step is not None and not crashed
                and rec.status == JobStatus.PROCESSING
                and rec.progress_step >= crash_at_step):
            g = p.guardians[j]
            g.runtimes[0].kill()
            p.cluster.fail_pod(g.pods[0].name)
            crashed = True
    assert c.status(j) == JobStatus.COMPLETED
    bucket = MountedBucket(p.objstore, "results")
    final = ckpt.latest_step(bucket, f"{j}/ckpt")
    leaves, meta = ckpt.restore(bucket, f"{j}/ckpt", final)
    done = json.loads(bucket.read(f"{j}/model/DONE"))
    return final, leaves, meta, done, crashed


def _crash_resume_is_bit_equal(torch_learners, device):
    built = torch_learners(device)
    step_a, leaves_a, _, done, _ = run_job(crash_at_step=None)
    n_uninterrupted = len(built)
    step_b, leaves_b, meta, _, crashed = run_job(crash_at_step=30)
    assert crashed and len(built) == n_uninterrupted + 2  # the crashed one, its restart
    assert step_a == step_b == 60 and done == {"steps": 60} and meta == {"final": True}
    assert built[-1].loss_history[0][0] >= 20  # the restart resumed, not restarted
    assert set(leaves_a) == set(leaves_b)
    for path in leaves_a:
        assert leaves_a[path].dtype == leaves_b[path].dtype
        assert torch.equal(leaves_a[path], leaves_b[path]), path


def test_crash_resume_through_the_platform_is_bit_equal(torch_learners):
    """A crash at step 30 of 60 resumes from the step-20 checkpoint to final
    params, optimizer state and step equal bit for bit to an uninterrupted
    run's."""
    _crash_resume_is_bit_equal(torch_learners, "cpu")


def test_loss_falls_through_the_platform(torch_learners):
    built = torch_learners("cpu")
    p = FfDLPlatform(n_hosts=2, chips_per_host=4)
    c = ApiClient.for_platform(p)
    j = c.submit(JobManifest(
        name="learn", arch="smollm-360m", n_learners=1, chips_per_learner=2,
        checkpoint_interval=100,
        train={"steps": 120, "batch": 8, "seq": 64, "lr": 1e-3, "warmup": 10}))
    for _ in range(4000):
        p.tick()
        if p.meta.get(j).status in (JobStatus.COMPLETED, JobStatus.FAILED):
            break
    assert c.status(j) == JobStatus.COMPLETED
    bucket = MountedBucket(p.objstore, "results")
    assert ckpt.latest_step(bucket, f"{j}/ckpt") == 120
    # the loss as sampled once a tick (every 5 steps): the tiny model learns
    # the progressions slowly, and the reference's own jitted train step
    # falls by about 0.06 over the same 120 steps of this stream
    losses = [loss for _, loss in built[-1].loss_history]
    assert built[-1].loss_history[-1][0] == 119
    assert np.mean(losses[-3:]) < losses[0] - 0.03, losses


class _Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def test_non_finite_loss_exits_2():
    """A job whose loss goes non-finite fails with exit code 2."""
    store = ObjectStore()
    ctx = jexecutor.LearnerContext(
        job_id="nan", learner_idx=0,
        manifest=JobManifest(name="nan", arch="smollm-360m", checkpoint_interval=100,
                             train={"steps": 20, "batch": 2, "seq": 16, "lr": 1e30,
                                    "warmup": 0}),
        volume=jexecutor.JobVolume("nan"), clock=(clock := _Clock()), events=EventLog(clock),
        objstore=store)
    learner = TorchLearner(ctx, steps_per_tick=5, device="cpu")
    learner.start()
    for _ in range(10):
        learner.tick()
        if learner.done:
            break
    assert learner.done
    exit_ = json.loads(ctx.volume.read("exit/learner-0"))
    assert exit_["code"] == 2 and "non-finite" in exit_["msg"]
    assert json.loads(ctx.volume.read("status/learner-0"))["status"] == "FAILED"


def test_learner_without_card_fails_the_job_cleanly():
    """Asked for the card where there is none, the learner's build fails
    and the job's learner exits 1, as the reference's does on any build
    error."""
    if torch.cuda.is_available():
        pytest.skip("this checks the path taken where no card is present")
    ctx = jexecutor.LearnerContext(
        job_id="nocard", learner_idx=0,
        manifest=JobManifest(name="nocard", arch="smollm-360m"),
        volume=jexecutor.JobVolume("nocard"), clock=(clock := _Clock()), events=EventLog(clock),
        objstore=ObjectStore())
    learner = TorchLearner(ctx)
    learner.start()
    learner.tick()
    assert learner.done
    assert json.loads(ctx.volume.read("exit/learner-0"))["code"] == 1


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys, one_thread):
    """``python -m repro_torch.launch.train`` trains 6 steps with checkpoints
    every 3; a second call (in process, to read its state) resumes from
    step 6."""
    base = ["--arch", "smollm-360m", "--tiny", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "3", "--ckpt-every", "3"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *base, "--steps", "6",
         "--ckpt-dir", str(tmp_path / "a")],
        capture_output=True, text=True, env=env, timeout=300, check=True).stdout
    assert "step     3 loss" in out and "step     6 loss" in out and "tok/s" in out
    assert "checkpoints: [3, 6]" in out
    state = train_cli.main(base + ["--steps", "9", "--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 6" in out and "step     9 loss" in out
    assert int(state.step) == 9
    bucket = DirBucket(str(tmp_path / "a"))
    assert ckpt.steps_available(bucket, "ckpt") == [3, 6, 9]
    resumed, meta = ckpt.restore(bucket, "ckpt", 9)
    assert meta == {"final": True} and int(resumed["step"]) == 9
    assert all(torch.isfinite(t.float()).all() for t in resumed.values())


@pytest.fixture
def world_of_one():
    """A one-process gloo group for the CLI's 1x1 mesh, gone after the test
    (kept where one was there already)."""
    import torch.distributed as dist
    owned = not dist.is_initialized()
    yield
    if owned and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("extra", [[], ["--sp"], ["--batch-tp"]], ids=["mesh", "sp", "batch_tp"])
def test_train_cli_sharding_options_run_on_a_1x1_mesh(world_of_one, capsys, extra, one_thread):
    """``--mesh 1x1`` with each of the reference's sharding options trains
    on a one-process mesh (params and optimizer state as DTensors) and
    takes the unsharded run's steps: on one device every placement is whole."""
    base = ["--arch", "smollm-360m", "--tiny", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    train_cli.main(base)
    plain = capsys.readouterr().out
    state = train_cli.main(base + ["--mesh", "1x1", *extra])
    out = capsys.readouterr().out
    assert "mesh=1x1" in out
    from torch.distributed.tensor import DTensor
    assert isinstance(state.params["embed"], DTensor)
    assert isinstance(state.opt.m["embed"], DTensor)
    losses = lambda text: [ln.split("loss")[1].split()[0]  # noqa: E731
                           for ln in text.splitlines() if ln.startswith("step")]
    assert losses(out) == losses(plain) and len(losses(out)) == 2


def test_train_cli_mesh_must_match_the_world(world_of_one):
    """A mesh whose product is not the world size exits with the reference's
    message."""
    with pytest.raises(SystemExit, match="mesh 2x2 needs 4 devices, have 1"):
        train_cli.main(["--arch", "smollm-360m", "--tiny", "--device", "cpu", "--mesh", "2x2"])


@pytest.mark.gpu
def test_crash_resume_through_the_platform_on_card(torch_learners):
    """The same crash at step 30 of 60 with the learner on the card: the
    deterministic step (the flash kernels, cuBLAS under
    use_deterministic_algorithms) makes the resumed run's final state equal
    the uninterrupted run's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the learner trains there with the flash kernels "
                    "(python3 chip_smoke.py runs the same crash-resume)")
    _crash_resume_is_bit_equal(torch_learners, "cuda")
