"""Hopper flash-attention forward: ``csrc/flash_attention.cu``, bound with
ctypes.

It replaces the TPU kernel ``repro/kernels/flash_attention.py:_flash_kernel``
and computes what that kernel does (GQA; causal, local-window or
bidirectional masks; absolute ``q_offset``; fp32 online softmax), for fp32
and bf16, head_dim 16, 32, 64, 128 and 256, and any sequence lengths. The source's
header says what bounds it on the card and what the design does about it.
Its plain version is ``repro_torch.kernels.ref.flash_attention_ref``.

The library is built at the first launch (``_build``). The wrapper checks
what the kernel takes and raises on anything else; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fwd():
    """The C entry point, typed; the library is built at the first call."""
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block at ``head_dim``, from the source."""
    fn = _build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(head_dim)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors only")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v differ in dtype or device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not supported "
                         f"(takes {list(_DTYPE_CODES)})")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {d} not in {HEAD_DIMS}")
    if h % k.shape[1]:
        raise ValueError(f"flash_attention_cuda: {h} q heads not a multiple of "
                         f"{k.shape[1]} kv heads")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention_cuda: empty inputs")


def flash_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B, H, Sq, D); k/v: (B, KV, Skv, D), CUDA, contiguous, one dtype.
    Returns (B, H, Sq, D) in q's dtype, on q's device and current stream."""
    _check(q, k, v)
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_cuda: window and q_offset must be >= 0")
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     b, h, n_kv, sq, skv, d, _DTYPE_CODES[q.dtype],
                     int(bool(causal)), int(window), int(q_offset),
                     float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0  # kernel launches since the last reset
