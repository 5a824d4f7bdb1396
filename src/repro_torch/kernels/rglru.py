"""Hopper RG-LRU scan: ``csrc/rglru.cu``, bound with ctypes.

It replaces the TPU kernel ``repro/kernels/rglru.py:_rglru_kernel`` and
computes what that kernel does: the linear recurrence h_t = a_t·h_{t-1} +
b_t over axis 1 of (B, S, W), a and b both fp32 or both bf16, an optional
fp32 h0, h in b's dtype and h_last in fp32, fp32 inside. It takes any B, S
and W.

The scan is bound by bytes. A block owns one batch row and 16 consecutive
lanes of W and walks all of S; a producer warp keeps a deep ring of time
tiles of a and b in flight in shared memory (TMA boxes where the row stride
and the pointers lie on 16 bytes, the producer's own loads elsewhere), and
each consumer thread walks one lane with h in a register, rounding
``a·h`` and then ``+ b`` like the plain version: the kernel equals
``repro_torch.kernels.ref.rglru_scan_ref`` bit for bit, and two launches
give the same bits. The source's header has the numbers and the designs
that were not taken.

The library is built at the first launch (``_build``). The wrapper checks
what the kernel takes and raises on anything else; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fwd():
    """The C entry point, typed; the library is built at the first call."""
    fn = _build.load("rglru").rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block at ``dtype``, from the source."""
    fn = _build.load("rglru").rglru_scan_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(_DTYPE_CODES[dtype])


def uses_tma(a, b) -> bool:
    """Whether a launch on ``a``, ``b`` loads its tiles with TMA (else with
    the producer warp's ordinary loads)."""
    fn = _build.load("rglru").rglru_scan_uses_tma
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return bool(fn(a.data_ptr(), b.data_ptr(), a.shape[-1], _DTYPE_CODES[a.dtype]))


def _check(a, b, h0):
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"rglru_scan_cuda: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors only")
        if t.dim() != 3:
            raise ValueError(f"rglru_scan_cuda: {name} must be (B, S, W), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan_cuda: {name} must be contiguous")
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"rglru_scan_cuda: a {tuple(a.shape)} {a.dtype} and "
                         f"b {tuple(b.shape)} {b.dtype} differ")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"rglru_scan_cuda: dtype {a.dtype} not supported "
                         f"(takes {list(_DTYPE_CODES)})")
    if a.numel() == 0:
        raise ValueError("rglru_scan_cuda: empty inputs")
    if h0 is not None and (h0.device != a.device or h0.dtype != torch.float32
                           or tuple(h0.shape) != (a.shape[0], a.shape[2])
                           or not h0.is_contiguous()):
        raise ValueError(f"rglru_scan_cuda: h0 must be contiguous fp32 "
                         f"{(a.shape[0], a.shape[2])} on {a.device}, got "
                         f"{tuple(h0.shape)} {h0.dtype} on {h0.device}")


def rglru_scan_cuda(a, b, h0=None):
    """a, b: (B, S, W), CUDA, contiguous, one dtype; h0: (B, W) fp32 or
    None. Returns (h (B, S, W) in b's dtype, h_last (B, W) fp32), on a's
    device and current stream. The kernel has no backward yet: with grad
    on and an input that requires grad it raises, since its output would
    carry no gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (a, b, h0)):
        raise NotImplementedError(
            "rglru_scan_cuda: the scan kernel has no backward yet, so its output "
            "would carry no gradient; recurrentgemma training (the scan's reverse "
            "backward) is ROADMAP A.9")
    _check(a, b, h0)
    bsz, s, w = a.shape
    h = torch.empty_like(b)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _fwd()(a.data_ptr(), b.data_ptr(),
                     None if h0 is None else h0.data_ptr(),
                     h.data_ptr(), h_last.data_ptr(), bsz, s, w,
                     _DTYPE_CODES[a.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_fwd launch failed: cudaError {err}")
    rglru_scan_cuda.launches += 1
    return h, h_last


rglru_scan_cuda.launches = 0  # kernel launches since the last reset
