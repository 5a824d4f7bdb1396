"""Dispatching wrappers: the Hopper kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The model code calls these. ``force`` picks a path explicitly: ``"kernel"``
(raises on a CPU tensor) or ``"ref"`` (the plain version, on any device).
There is no fallback: a CUDA tensor reaches the kernel or an exception.
With grad on, flash attention on the card goes through
``FlashAttentionFn`` and the RG-LRU scan through ``RGLRUScanFn`` (each the
forward kernel, then its backward kernel); the plain versions carry
autograd on their own.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.rglru import RGLRUScanFn, rglru_scan_bwd_cuda, rglru_scan_cuda

_FORCES = (None, "kernel", "ref")
_KERNELS = {"flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "rglru_scan": rglru_scan_cuda,
            "rglru_scan_bwd": rglru_scan_bwd_cuda}


def _plain(x, force) -> bool:
    """Whether the plain version runs: forced, or x lies off the card."""
    if force not in _FORCES:
        raise ValueError(f"force must be one of {_FORCES}, got {force!r}")
    return force == "ref" or (force is None and not x.is_cuda)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    force: str | None = None):
    """GQA flash attention. force in {None, 'kernel', 'ref'}. On the card,
    with grad on and an input that requires grad, the output's grad_fn is
    ``FlashAttentionFn``, whose backward is the backward kernel."""
    if _plain(q, force):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)


def rglru_scan(a, b, h0=None, *, force: str | None = None):
    """Linear recurrence h_t = a_t*h_{t-1} + b_t over axis 1. Returns
    (h in b's dtype, h_last fp32). force in {None, 'kernel', 'ref'}. On the
    card, with grad on and an input that requires grad, the outputs'
    grad_fn is ``RGLRUScanFn``, whose backward is the backward kernel."""
    if _plain(a, force):
        return ref.rglru_scan_ref(a, b, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (a, b, h0)):
        return RGLRUScanFn.apply(a, b, h0)
    return rglru_scan_cuda(a, b, h0)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
