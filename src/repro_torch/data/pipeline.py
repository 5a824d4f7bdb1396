"""Deterministic synthetic token pipeline: the port's own copy of the
reference's ``DataConfig`` and ``SyntheticLM`` (``repro/data/pipeline.py``),
in numpy.

``batch_at(step)`` is a pure function of (seed, step, host index), the same
bits as the reference's, so a learner that resumes from a checkpoint at step
k regenerates exactly the batches the crashed learner would have seen: what
lets a crash-resumed run end on bit-equal parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
