"""Deterministic synthetic token pipeline: the port's own copy of the
reference's ``DataConfig``, ``SyntheticLM`` and ``PrefetchIterator``
(``repro/data/pipeline.py``), in numpy, and ``shard_batch``, which puts a
host batch on a mesh.

``batch_at(step)`` is a pure function of (seed, step, host index), the same
bits as the reference's, so a learner that resumes from a checkpoint at step
k regenerates exactly the batches the crashed learner would have seen: what
lets a crash-resumed run end on bit-equal parameters.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import NamedSharding, logical_to_spec, place


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0


class SyntheticLM:
    """Synthetic next-token-prediction stream with a learnable structure.

    Tokens follow a noisy arithmetic progression per sequence, so models can
    actually reduce loss on it; labels are the next token.
    """

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} is not a multiple of "
                             f"n_hosts {cfg.n_hosts}")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        b, s = self.local_batch, cfg.seq_len
        start = rng.integers(0, cfg.vocab_size, (b, 1))
        stride = rng.integers(1, 7, (b, 1))
        seq = (start + stride * np.arange(s + 1)) % cfg.vocab_size
        noise = rng.random((b, s + 1)) < 0.05
        seq = np.where(noise, rng.integers(0, cfg.vocab_size, (b, s + 1)), seq)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch of a batch iterator (the load-data helper).

    ``workers`` scales the synthetic per-batch preparation cost the way CPU
    feeder threads scale input throughput in the paper's Tables 4/6.
    """

    def __init__(self, source: Iterator[dict], prefetch: int = 2,
                 workers: int = 1, prep_cost_s: float = 0.0):
        self.source = source
        self.prep_cost_s = prep_cost_s
        self.workers = max(1, workers)
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self.source:
            if self._stop.is_set():
                return
            if self.prep_cost_s:
                time.sleep(self.prep_cost_s / self.workers)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()


def shard_batch(batch: dict, env=None, device="cpu") -> dict:
    """A host batch (numpy arrays or tensors, the same on every rank) as
    tensors on ``device``: integer arrays as int64, floating ones in their
    own dtype. Under ``env`` (a MeshEnv with a device mesh) each is a DTensor
    split on its leading dim by the ``("batch", None, ...)`` spec, each rank
    keeping its own rows; a DTensor is taken as it is."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v
            continue
        t = torch.as_tensor(v)
        t = t.to(device) if t.is_floating_point() else t.to(device, torch.long)
        if env is not None and env.active:
            spec = logical_to_spec(("batch",) + (None,) * (t.dim() - 1), env, t.shape)
            t = place(t, NamedSharding(env.mesh, spec))
        out[k] = t
    return out
