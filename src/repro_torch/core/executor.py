"""Learner runtime: what runs inside learner pods, the port's copy of the
reference's ``repro/core/executor.py``.

FfDL treats the framework as opaque: learners talk to the platform only
through "lowest common denominator" channels (§7), a shared filesystem
(exit-code and status files on the job's NFS volume), environment-style
config, and logs to stdout. So:

  * ``JobVolume``: the shared NFS volume, plain key→bytes files that
    persist across pod crashes (a PVC), deleted at job GC.
  * ``LearnerContext``: what the guardian hands a learner: the job's
    manifest, its volume, the clock, the event log, the object store, and
    the device a real job trains on (the platform's; None is the card).
  * ``SimLearner``: the workload model of the scheduler-scale scenarios,
    running for ``sim_duration`` clock-seconds and touching no device.
  * ``TorchLearner``: a real PyTorch training job, the counterpart of the
    reference's ``RealLearner``: model from ``configs/``, optimizer, data
    pipeline, checkpoint and restore through the object store. On restart
    it resumes from the latest valid checkpoint, the paper's recovery
    contract.

Learners never talk to the guardian directly: they write
``status/learner-<k>`` and ``exit/learner-<k>`` files; the controller helper
(``controller.py``) relays them to etcd. ``make_learner`` picks the learner
for a manifest: ``TorchLearner`` for one with an arch, ``SimLearner``
otherwise.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.types import EventLog, JobManifest


class JobVolume:
    """Shared NFS volume (PVC): survives pod crashes, deleted at job GC."""

    def __init__(self, job_id: str):
        self.job_id = job_id
        self.files: dict[str, str] = {}
        self.provisioned = True

    def write(self, path: str, content: str):
        if not self.provisioned:
            raise IOError(f"volume for {self.job_id} not provisioned")
        self.files[path] = content

    def read(self, path: str) -> Optional[str]:
        if not self.provisioned:
            raise IOError(f"volume for {self.job_id} not provisioned")
        return self.files.get(path)

    def list(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self.files if k.startswith(prefix))


@dataclass
class LearnerContext:
    job_id: str
    learner_idx: int
    manifest: JobManifest
    volume: JobVolume
    clock: Any
    events: EventLog
    objstore: Any  # ObjectStore (checkpoints + results)
    device: Any = None  # where a real job trains (None: the card)

    @property
    def pod_name(self) -> str:
        return f"{self.job_id}-l{self.learner_idx}"

    def set_status(self, status: str, extra: Optional[dict] = None):
        payload = {"status": status, "ts": self.clock.now(),
                   "step": (extra or {}).get("step", 0)}
        payload.update(extra or {})
        self.volume.write(f"status/learner-{self.learner_idx}",
                          json.dumps(payload))

    def write_exit(self, code: int, msg: str = ""):
        self.volume.write(f"exit/learner-{self.learner_idx}",
                          json.dumps({"code": code, "msg": msg,
                                      "ts": self.clock.now()}))

    def log(self, line: str):
        prev = self.volume.files.get(f"logs/learner-{self.learner_idx}", "")
        self.volume.write(f"logs/learner-{self.learner_idx}",
                          prev + line + "\n")


class SimLearner:
    """Clock-driven workload model (used by scale/scheduling benchmarks).

    Phases: DOWNLOADING (data_latency) → PROCESSING (sim_duration) →
    STORING (store_latency) → exit 0. ``kill()`` models a process crash;
    progress resumes from the last checkpoint boundary.
    """

    DATA_LATENCY = 30.0
    STORE_LATENCY = 10.0
    CKPT_PERIOD = 120.0  # sim-seconds of work per checkpoint

    def __init__(self, ctx: LearnerContext, slowdown: float = 1.0):
        self.ctx = ctx
        self.slowdown = slowdown
        self.phase = "INIT"
        self.progress = 0.0  # seconds of work completed
        self.checkpointed = 0.0  # durable progress
        self._phase_started = None
        self.done = False
        self.stalled = False  # chaos: silent straggler (alive, no progress)

    def stall(self):
        self.stalled = True

    def start(self, resume: bool = False):
        self.phase = "DOWNLOADING"
        self._phase_started = self.ctx.clock.now()
        if resume:
            # durable progress lives on the volume (survives process death)
            raw = self.ctx.volume.read(f"ckpt/learner-{self.ctx.learner_idx}")
            self.checkpointed = float(raw) if raw else 0.0
            self.progress = self.checkpointed
        self.ctx.set_status("DOWNLOADING")

    def kill(self):
        self.phase = "DEAD"

    def tick(self):
        if self.phase in ("INIT", "DEAD") or self.done:
            return
        now = self.ctx.clock.now()
        dur = self.ctx.manifest.sim_duration or 60.0
        if self.phase == "DOWNLOADING":
            if now - self._phase_started >= self.DATA_LATENCY:
                self.phase = "PROCESSING"
                self._phase_started = now
                self._last = now
                self.ctx.set_status("PROCESSING")
                # learners log to stdout; the LogCollector tails it into
                # the searchable index (§3.2) — and `logs --follow` streams
                # it live over the wire
                self.ctx.log(f"processing started "
                             f"(target {dur:.0f} sim-seconds)")
            return
        if self.phase == "PROCESSING":
            if not self.stalled:
                self.progress += (now - self._last) / self.slowdown
            self._last = now
            self.ctx.set_status("PROCESSING", {"progress": self.progress})
            if self.progress - self.checkpointed >= self.CKPT_PERIOD:
                self.checkpointed = self.progress
                self.ctx.volume.write(
                    f"ckpt/learner-{self.ctx.learner_idx}",
                    str(self.checkpointed))
                self.ctx.log(f"checkpointed at progress "
                             f"{self.checkpointed:.0f}/{dur:.0f}")
            if self.progress >= dur:
                self.phase = "STORING"
                self._phase_started = now
                self.ctx.set_status("STORING")
                self.ctx.log("storing results")
            return
        if self.phase == "STORING":
            if now - self._phase_started >= self.STORE_LATENCY:
                self.done = True
                self.ctx.set_status("COMPLETED", {"progress": self.progress})
                self.ctx.log("completed")
                self.ctx.write_exit(0)




class TorchLearner:
    """An actual PyTorch training job driven through the platform.

    Runs ``steps_per_tick`` optimizer steps per platform tick; checkpoints
    every ``manifest.checkpoint_interval`` steps to the object store; on
    (re)start, resumes from the newest valid checkpoint, which the reference
    learner may have written as well. Phases INIT → DOWNLOADING (build and
    restore) → PROCESSING → STORING (final checkpoint, ``model/DONE``),
    then exit 0; a non-finite loss exits 2. ``device`` defaults to the card.
    """

    def __init__(self, ctx: LearnerContext, steps_per_tick: int = 5, device=None):
        self.ctx = ctx
        self.steps_per_tick = steps_per_tick
        self.device = device
        self.phase = "INIT"
        self.done = False
        self._state = None
        self._train_step = None
        self._data = None
        self._bucket = None
        self.loss_history: list[tuple[int, float]] = []

    # -- setup ----------------------------------------------------------
    def _build(self):
        from repro_torch.configs import get_config, get_tiny_config
        from repro_torch.convert import train_state_from_numpy
        from repro_torch.data.objectstore import MountedBucket
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
        from repro_torch.launch.serve import resolve_device
        from repro_torch.launch.train import deterministic
        from repro_torch.models import steps as msteps
        from repro_torch.optim import adamw

        device = resolve_device(self.device)
        deterministic(device)  # before the first product on the card
        m = self.ctx.manifest
        t = m.train
        cfg = (get_tiny_config(m.arch) if t.get("tiny", True)
               else get_config(m.arch))
        for k, v in t.get("overrides", {}).items():
            cfg = cfg.replace(**{k: v})
        self.cfg = cfg
        self.total_steps = int(t.get("steps", 100))
        opt_cfg = adamw.AdamWConfig(
            lr=t.get("lr", 3e-4), warmup_steps=t.get("warmup", 10),
            total_steps=self.total_steps)
        self._train_step = msteps.make_train_step(cfg, opt_cfg)
        self._data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=t.get("seq", 128),
            global_batch=t.get("batch", 8), seed=t.get("seed", 0)))
        self._bucket = MountedBucket(self.ctx.objstore,
                                     self.ctx.manifest.results_bucket)
        self.ctx.objstore.create_bucket(self.ctx.manifest.results_bucket)
        self._ckpt_prefix = f"{self.ctx.job_id}/ckpt"

        # Resume from the latest valid checkpoint if one exists (§3.8).
        latest = ckpt.latest_step(self._bucket, self._ckpt_prefix)
        if latest is not None:
            flat, _ = ckpt.restore(self._bucket, self._ckpt_prefix, latest)
            self._state = train_state_from_numpy(flat, cfg, device)
            self.ctx.log(f"resumed from checkpoint step {latest}")
            self.ctx.events.emit("learner", "resume_from_checkpoint",
                                 job=self.ctx.job_id, step=latest)
        else:
            self._state = msteps.init_train_state(cfg, int(t.get("seed", 0)), device)

    def start(self, resume: bool = False):
        self.phase = "DOWNLOADING"
        self.ctx.set_status("DOWNLOADING")

    def kill(self):
        self.phase = "DEAD"
        self._state = None  # lose in-memory state, like a real process crash
        self._train_step = None

    @property
    def step(self) -> int:
        return int(self._state.step) if self._state is not None else 0

    def tick(self):
        if self.phase in ("INIT", "DEAD") or self.done:
            return
        if self.phase == "DOWNLOADING":
            try:
                self._build()
            except Exception as e:  # surfaces as learner failure
                self.ctx.log(f"fatal: {e}")
                self.ctx.set_status("FAILED", {"error": str(e)})
                self.ctx.write_exit(1, str(e))
                self.done = True
                return
            self.phase = "PROCESSING"
            self.ctx.set_status("PROCESSING", {"step": self.step})
            return
        if self.phase == "PROCESSING":
            m = self.ctx.manifest
            last_metrics = None
            for _ in range(self.steps_per_tick):
                step = self.step
                if step >= self.total_steps:
                    break
                batch = self._data.batch_at(step)
                self._state, metrics = self._train_step(self._state, batch)
                last_metrics = (step, metrics)
                if (step + 1) % m.checkpoint_interval == 0:
                    loss = float(metrics["loss"])
                    ckpt.save(self._bucket, self._ckpt_prefix, step + 1,
                              self._state, {"loss": loss})
                    self.ctx.events.emit("learner", "checkpoint",
                                         job=self.ctx.job_id, step=step + 1)
            # status/metric sync once per tick (periodic updates, §2), not
            # per step, so the platform never serializes the device queue.
            if last_metrics is not None:
                step, metrics = last_metrics
                loss = float(metrics["loss"])
                self.loss_history.append((step, loss))
                if not math.isfinite(loss):
                    self.ctx.set_status("FAILED", {"error": "nan loss"})
                    self.ctx.write_exit(2, "non-finite loss")
                    self.done = True
                    return
            self.ctx.set_status("PROCESSING", {"step": self.step})
            if self.step >= self.total_steps:
                self.phase = "STORING"
                self.ctx.set_status("STORING", {"step": self.step})
            return
        if self.phase == "STORING":
            ckpt.save(self._bucket, self._ckpt_prefix, self.step,
                      self._state, {"final": True})
            self._bucket.write(f"{self.ctx.job_id}/model/DONE",
                               json.dumps({"steps": self.step}))
            self.done = True
            self.ctx.set_status("COMPLETED", {"step": self.step})
            self.ctx.write_exit(0)


def make_learner(ctx: LearnerContext):
    if ctx.manifest.arch is not None:
        return TorchLearner(ctx, device=ctx.device)
    return SimLearner(ctx)
