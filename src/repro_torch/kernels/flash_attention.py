"""Hopper flash attention, bound with ctypes. The forward takes one of two
routes:

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

The backward has no TPU counterpart: the JAX package trains through
autodiff of its jnp twin. It takes one of two routes too (``BWD_ROUTES``),
at the forward's head dims:

- bf16 takes ``csrc/flash_attention_bwd_sm90.cu`` (head_dim 16 to 256): all
  seven products on wgmma, Q/K/V/dO tiles loaded by TMA into swizzled
  shared memory, a ring of streamed tiles on mbarriers; at head_dim 256 two
  consumer warpgroups split dK and dV by columns;
- fp32 takes ``csrc/flash_attention_bwd.cu`` (head_dim 16 to 256): mma.sync
  on the tensor cores, each fp32 product as three TF32 products of split operands (P and
  dS kept fp32), a two-stage cp.async ring of streamed tiles; at head_dim
  256 two warps share each 16-row slab, splitting dK, dV and dQ by columns;
  the forward's TF32 helpers are shared through ``csrc/tf32.cuh``.

Both are deterministic (the FlashAttention-2 split into a Δ pass, a dK/dV
kernel and a dQ kernel, no atomics) and recompute the probabilities from
the forward's fp32 logsumexp, which the forward writes when asked
(``return_lse``). ``FlashAttentionFn`` binds forward and backward for
autograd; the backward's plain version is ``ref.flash_attention_bwd_ref``.

A library is built at its first launch (``_build``). The wrappers check
what the kernels take (among it a 16-byte-aligned pointer, which TMA
needs) and raise on anything else; they never fall back to the other route
or to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, cost

HEAD_DIMS = (16, 32, 64, 128, 256)  # the forward's and, on both routes, the backward's
# dtype -> (source in csrc/, which is also its C entry points' prefix; route name)
ROUTES = {torch.bfloat16: ("flash_attention_sm90", "cuda-wgmma"),
          torch.float32: ("flash_attention", "cuda-fp32")}
BWD_ROUTES = {torch.bfloat16: ("flash_attention_bwd_sm90", "cuda-wgmma"),
              torch.float32: ("flash_attention_bwd", "cuda-fp32")}


@functools.cache
def _fwd(dtype):
    """The route's C entry point, typed; its library is built at the first call."""
    source, _ = ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
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


def _check(q, k, v, device="cuda"):
    """What the kernels take; ``device`` "meta" checks a shape function's
    inputs (which lie on no card and have no storage)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != device:
            raise ValueError(f"flash_attention_{device}: {name} is on {t.device}, the "
                             + ("kernel takes CUDA" if device == "cuda" else
                                "shape function takes meta") + " tensors only")
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


def flash_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                         return_lse=False):
    """q: (B, H, Sq, D); k/v: (B, KV, Skv, D), CUDA, contiguous, 16-byte
    aligned, one dtype: bf16 takes the wgmma route, fp32 the split-TF32 one.
    Returns (B, H, Sq, D) in q's dtype, on q's device and current stream;
    with ``return_lse`` also each row's fp32 logsumexp (B, H, Sq)."""
    _check(q, k, v)
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_cuda: window and q_offset must be >= 0")
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = _fwd(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            None if lse is None else lse.data_ptr(),
                            b, h, n_kv, sq, skv, d, int(bool(causal)), int(window),
                            int(q_offset), float(d ** -0.5),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{ROUTES[q.dtype][0]}_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    cost.report_attention(q, k, v, (o, lse), causal=causal, window=window, q_offset=q_offset)
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0  # kernel launches since the last reset


def flash_attention_meta(q, k, v, *, causal=True, window=0, q_offset=0,
                         return_lse=False):
    """The forward kernel's shape function on meta tensors (the dry-run's):
    it checks what ``flash_attention_cuda`` checks, allocates what it
    allocates (o, and the fp32 lse when asked), reports the kernel's cost
    (``cost``) and launches nothing: no (B, H, Sq, Skv) scores, as the
    kernel keeps none."""
    _check(q, k, v, "meta")
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_meta: window and q_offset must be >= 0")
    b, h, sq, _ = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    cost.report_attention(q, k, v, (o, lse), causal=causal, window=window, q_offset=q_offset)
    return (o, lse) if return_lse else o


@functools.cache
def _bwd(dtype):
    """The backward route's C entry point, typed; its library is built at
    the first call."""
    source, _ = BWD_ROUTES[dtype]
    fn = getattr(_build.load(source), source)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bwd_smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the larger of the two tile kernels' blocks
    of ``dtype``'s backward route at ``head_dim``, from the source."""
    source, _ = BWD_ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(head_dim)


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal=True, window=0,
                             q_offset=0):
    """The attention backward on the card: (dq, dk, dv) in the inputs' dtype
    from q, k, v, the forward's o, its gradient ``do`` (all contiguous,
    one dtype: bf16 takes the wgmma route, whose TMA loads need o and do
    16-byte aligned too, fp32 the split-TF32 one, whose cp.async loads need
    the same and whose launch fails with cudaErrorMisalignedAddress
    otherwise) and the forward's fp32 ``lse`` (B, H, Sq). head_dim 16 to
    256 on both routes. Two launches on the same inputs give the same
    bits."""
    dq, dk, dv, delta = _bwd_outputs(q, k, v, o, do, lse, window, q_offset, "cuda")
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        err = _bwd(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), b, h, n_kv, sq, skv, d,
                            int(bool(causal)), int(window), int(q_offset), float(d ** -0.5),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BWD_ROUTES[q.dtype][0]} launch failed: cudaError {err}")
    flash_attention_bwd_cuda.launches += 1
    cost.report_attention(q, k, v, (dq, dk, dv, delta), (o, do, lse), causal=causal,
                          window=window, q_offset=q_offset, backward=True)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0  # backward calls (three kernels each) since the last reset


def flash_attention_bwd_meta(q, k, v, o, do, lse, *, causal=True, window=0,
                             q_offset=0):
    """The backward's shape function on meta tensors (the dry-run's): the
    checks and allocations of ``flash_attention_bwd_cuda`` (dq, dk, dv and
    the fp32 Δ scratch), its cost reported (``cost``), no launch."""
    dq, dk, dv, delta = _bwd_outputs(q, k, v, o, do, lse, window, q_offset, "meta")
    cost.report_attention(q, k, v, (dq, dk, dv, delta), (o, do, lse), causal=causal,
                          window=window, q_offset=q_offset, backward=True)
    return dq, dk, dv


def _bwd_outputs(q, k, v, o, do, lse, window, q_offset, device):
    """The backward's checks on ``device``'s tensors, and its outputs and
    scratch, allocated: (dq, dk, dv, the fp32 Δ)."""
    _check(q, k, v, device)
    b, h, sq, _ = q.shape
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_bwd_cuda: window and q_offset must be >= 0")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be contiguous "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd_cuda: {name} starts at a pointer that "
                             "is not 16-byte aligned (TMA needs it); pass a fresh "
                             "contiguous copy")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_cuda: lse must be contiguous fp32 "
                         f"{(b, h, sq)} on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return dq, dk, dv, torch.empty((b, h, sq), dtype=torch.float32, device=q.device)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with gradients on the card: the forward kernel, which
    also writes the rows' logsumexp, and the backward kernel. Both are
    deterministic, so a recompute under ``torch.utils.checkpoint``
    reproduces ``o`` and ``lse`` bit for bit."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        fwd = flash_attention_meta if q.is_meta else flash_attention_cuda
        o, lse = fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_meta if q.is_meta else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None, None, None
