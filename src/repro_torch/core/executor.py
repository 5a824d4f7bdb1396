"""The port's learner: a real PyTorch training job that the platform's
guardian runs, the counterpart of the reference's ``RealLearner``
(``repro/core/executor.py``).

Learners never talk to the guardian directly. Through the context they are
given (``ctx``: the job's manifest, its shared volume, the clock, the event
log and the object store) they write ``status/learner-<k>`` and
``exit/learner-<k>`` files and logs, and checkpoint to the results bucket.
The context is the platform's (``repro/core/executor.py:LearnerContext``)
and reaches the port by duck typing; the port imports nothing of it.
"""

from __future__ import annotations

import json
import math

from repro_torch.ckpt import checkpoint as ckpt


class TorchLearner:
    """An actual PyTorch training job driven through the platform.

    Runs ``steps_per_tick`` optimizer steps per platform tick; checkpoints
    every ``manifest.checkpoint_interval`` steps to the object store; on
    (re)start, resumes from the newest valid checkpoint, which the reference
    learner may have written as well. Phases INIT → DOWNLOADING (build and
    restore) → PROCESSING → STORING (final checkpoint, ``model/DONE``),
    then exit 0; a non-finite loss exits 2. ``device`` defaults to the card.
    """

    def __init__(self, ctx, steps_per_tick: int = 5, device=None):
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
