"""The training traffic's generator: a frozen copy of the port's
``data.pipeline.SyntheticLM.batch_at`` (itself the reference package's).

Each sequence is an arithmetic progression of token ids from a random start
with a random stride, a share ``noise`` of its tokens replaced by random
ids; the labels are the next tokens. A batch is a pure function of (seed,
step): every seed gives the same sizes, only other ids.
"""

from __future__ import annotations

import numpy as np


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int, noise: float = 0.05,
             stride: tuple = (1, 7)) -> dict:
    """{"tokens", "labels"}: (batch, seq) int32 numpy arrays."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, step, 0]))
    start = rng.integers(0, vocab, (batch, 1))
    step_ = rng.integers(stride[0], stride[1], (batch, 1))
    ids = (start + step_ * np.arange(seq + 1)) % vocab
    swap = rng.random((batch, seq + 1)) < noise
    ids = np.where(swap, rng.integers(0, vocab, (batch, seq + 1)), ids)
    return {"tokens": ids[:, :-1].astype(np.int32), "labels": ids[:, 1:].astype(np.int32)}


def make(traffic: dict, vocab: int, seed: int):
    """The traffic file's stream: step -> batch."""
    data = traffic["data"]
    return lambda step: batch_at(seed, step, traffic["batch"], traffic["seq"], vocab,
                                 data["noise"], tuple(data["stride"]))
