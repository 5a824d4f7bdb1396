"""Hopper flash-attention forward, two routes bound with ctypes:

- bf16 takes ``csrc/flash_attention_sm90.cu``: wgmma on the tensor cores,
  TMA loads into swizzled shared memory, a two-stage K/V ring on mbarriers;
- fp32 takes ``csrc/flash_attention.cu``: mma.sync on the tensor cores, each
  fp32 product as three TF32 products of split operands (hi = tf32(x),
  lo = x - hi), which hold fp32's tolerance where one TF32 product does
  not; a two-stage cp.async ring of K/V tiles.

Both replace the TPU kernel ``repro/kernels/flash_attention.py:_flash_kernel``
and compute what that kernel does (GQA; causal, local-window or
bidirectional masks; absolute ``q_offset``; fp32 online softmax), at head_dim
16, 32, 64, 128 and 256, and any sequence lengths. Each source's header says
what bounds it on the card and what its design does about it. Their plain
version is ``repro_torch.kernels.ref.flash_attention_ref``.

A library is built at its route's first launch (``_build``). The wrapper
checks what the kernels take (among it a 16-byte-aligned pointer, which TMA
needs) and raises on anything else; it never falls back to the other route
or to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
# dtype -> (source in csrc/, which is also its C entry points' prefix; route name)
ROUTES = {torch.bfloat16: ("flash_attention_sm90", "cuda-wgmma"),
          torch.float32: ("flash_attention", "cuda-fp32")}


@functools.cache
def _fwd(dtype):
    """The route's C entry point, typed; its library is built at the first call."""
    source, _ = ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of ``dtype``'s route at
    ``head_dim``, from the source."""
    source, _ = ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_smem_bytes")
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
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} starts at a pointer that is "
                             "not 16-byte aligned (TMA needs it); pass a fresh contiguous copy")
    if q.dtype not in ROUTES:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not supported "
                         f"(takes {list(ROUTES)})")
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
    """q: (B, H, Sq, D); k/v: (B, KV, Skv, D), CUDA, contiguous, 16-byte
    aligned, one dtype: bf16 takes the wgmma route, fp32 the split-TF32 one.
    Returns (B, H, Sq, D) in q's dtype, on q's device and current stream."""
    _check(q, k, v)
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_cuda: window and q_offset must be >= 0")
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fwd(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            b, h, n_kv, sq, skv, d, int(bool(causal)), int(window),
                            int(q_offset), float(d ** -0.5),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{ROUTES[q.dtype][0]}_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0  # kernel launches since the last reset
