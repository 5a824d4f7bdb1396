"""Kernel calls reported to a cost counter, and the kernels' own costs.

A hand-written kernel is not an ATen op, so a dispatch mode that counts a
step's ATen ops (``launch.op_cost``) never sees it. Each kernel wrapper, on
the card, and each kernel's shape function, on meta tensors, reports its
call here instead: the innermost active dispatch mode with a
``kernel_call(name, flops, nbytes)`` method counts it. With no dispatch mode
active a report costs one check, and the cost is not computed.

The costs are what the kernel must do for these inputs (``chip_smoke.py``'s
bounds count the same): 2 products of 2·D FLOP per unmasked (query, key)
pair and head for the flash forward, 5 for its backward (S recomputed, dP,
dV, dQ, dK); 2 FLOP an element for the scan, 3 for its backward. Bytes are
each input read once and each output written once.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def counter():
    """The innermost active dispatch mode that counts kernel calls (and
    loops, ``report_loop``), or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel_call"):
            return mode
    return None


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def unmasked_pairs(sq, skv, causal, window, q_offset=0) -> int:
    """(query, key) pairs that the masks keep, per (batch, head)."""
    qpos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv, dtype=np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def attention(q, k, causal, window, q_offset, backward: bool) -> int:
    """FLOPs of the flash forward (or, with ``backward``, its backward) on
    q (B, H, Sq, D) against k (B, KV, Skv, D)."""
    b, h, sq, d = q.shape
    pairs = unmasked_pairs(sq, k.shape[2], causal, window, q_offset)
    return (10 if backward else 4) * d * pairs * b * h


def report_attention(q, k, v, outputs, inputs=(), *, causal, window, q_offset,
                     backward=False):
    """Report one flash forward (outputs ``o``, ``lse``) or backward call."""
    c = counter()
    if c is not None:
        name = "flash_attention_bwd" if backward else "flash_attention"
        c.kernel_call(name, attention(q, k, causal, window, q_offset, backward),
                      _nbytes(q, k, v, *inputs, *outputs))


def report_scan(a, inputs, outputs, backward=False):
    """Report one scan (or, with ``backward``, scan backward) call on
    (B, S, W) ``a``."""
    c = counter()
    if c is not None:
        c.kernel_call("rglru_scan_bwd" if backward else "rglru_scan",
                      (3 if backward else 2) * a.numel(), _nbytes(*inputs, *outputs))


def report_loop(name, flops, nbytes):
    """Report a loop counted as one measured step times its steps (a meta
    shape function's, ``nn.recurrent``'s sLSTM)."""
    c = counter()
    if c is not None:
        c.loop_call(name, flops, nbytes)
