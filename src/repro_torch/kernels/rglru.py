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

Its backward, ``csrc/rglru_bwd.cu`` (``rglru_scan_bwd_cuda``), has no TPU
counterpart: the JAX package trains through autodiff of its associative
scan. It walks the same ring backward in time, fp32 only, and equals
``repro_torch.kernels.ref.rglru_scan_bwd_ref`` bit for bit.
``RGLRUScanFn`` binds forward and backward for autograd.

A library is built at its first launch (``_build``). The wrappers check
what the kernels take and raise on anything else; they never fall back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, cost

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


def _on(fn, name, t, device):
    """Raise unless ``t`` lies on ``device``: "cuda" for a kernel, "meta" for
    its shape function (the dry-run's)."""
    if t.device.type != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, the "
                         + ("kernel takes CUDA" if device == "cuda" else
                            "shape function takes meta") + " tensors only")


def _check(a, b, h0, device="cuda"):
    for name, t in (("a", a), ("b", b)):
        _on(f"rglru_scan_{device}", name, t, device)
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
    device and current stream. Its outputs carry no gradient: under grad,
    ``ops.rglru_scan`` calls it through ``RGLRUScanFn``."""
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
    cost.report_scan(a, (a, b, h0), (h, h_last))
    return h, h_last


rglru_scan_cuda.launches = 0  # kernel launches since the last reset


def rglru_scan_meta(a, b, h0=None):
    """The scan's shape function on meta tensors (the dry-run's): the checks
    and allocations of ``rglru_scan_cuda``, its cost reported (``cost``), no
    launch."""
    _check(a, b, h0, "meta")
    h = torch.empty_like(b)
    h_last = torch.empty((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    cost.report_scan(a, (a, b, h0), (h, h_last))
    return h, h_last


@functools.cache
def _bwd():
    """The backward's C entry point, typed; its library is built at the
    first call."""
    fn = _build.load("rglru_bwd").rglru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bwd_smem_bytes() -> int:
    """Dynamic shared memory of one block of the backward, from the source."""
    fn = _build.load("rglru_bwd").rglru_scan_bwd_smem_bytes
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def bwd_uses_tma(a, h, g) -> bool:
    """Whether a backward launch on ``a``, ``h``, ``g`` loads its tiles with
    TMA (else with the producer warp's ordinary loads)."""
    fn = _build.load("rglru_bwd").rglru_scan_bwd_uses_tma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    fn.restype = ctypes.c_int
    return bool(fn(a.data_ptr(), h.data_ptr(), g.data_ptr(), a.shape[-1]))


def _check_bwd(a, h, g, h0, g_last, device="cuda"):
    for name, t in (("a", a), ("h", h), ("g", g)):
        _on(f"rglru_scan_bwd_{device}", name, t, device)
        if t.dim() != 3 or t.shape != a.shape:
            raise ValueError(f"rglru_scan_bwd_cuda: {name} must be (B, S, W) "
                             f"{tuple(a.shape)}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan_bwd_cuda: {name} is {t.dtype}; the backward "
                             "takes fp32 (the model's coefficients are fp32)")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"rglru_scan_bwd_cuda: {name} must be contiguous on {a.device}")
    if a.numel() == 0:
        raise ValueError("rglru_scan_bwd_cuda: empty inputs")
    for name, t in (("h0", h0), ("g_last", g_last)):
        if t is not None and (t.device != a.device or t.dtype != torch.float32
                              or tuple(t.shape) != (a.shape[0], a.shape[2])
                              or not t.is_contiguous()):
            raise ValueError(f"rglru_scan_bwd_cuda: {name} must be contiguous fp32 "
                             f"{(a.shape[0], a.shape[2])} on {a.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def rglru_scan_bwd_cuda(a, h, g, h0=None, g_last=None):
    """The scan's backward on the card: from the forward's a and output h,
    the gradient g of h (all (B, S, W) fp32, CUDA, contiguous) and the
    gradient g_last of h_last ((B, W) fp32 or None), with the forward's h0
    ((B, W) fp32 or None), returns (da, db (B, S, W) fp32, dh0 (B, W) fp32
    or None without h0), on a's device and current stream. Two launches on
    the same inputs give the same bits."""
    _check_bwd(a, h, g, h0, g_last)
    bsz, s, w = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    with torch.cuda.device(a.device):
        err = _bwd()(a.data_ptr(), h.data_ptr(), g.data_ptr(),
                     None if h0 is None else h0.data_ptr(),
                     None if g_last is None else g_last.data_ptr(),
                     da.data_ptr(), db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
                     bsz, s, w, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed: cudaError {err}")
    rglru_scan_bwd_cuda.launches += 1
    cost.report_scan(a, (a, h, g, h0, g_last), (da, db, dh0), backward=True)
    return da, db, dh0


rglru_scan_bwd_cuda.launches = 0  # kernel launches since the last reset


def rglru_scan_bwd_meta(a, h, g, h0=None, g_last=None):
    """The backward's shape function on meta tensors (the dry-run's): the
    checks and allocations of ``rglru_scan_bwd_cuda``, its cost reported
    (``cost``), no launch."""
    _check_bwd(a, h, g, h0, g_last, "meta")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    cost.report_scan(a, (a, h, g, h0, g_last), (da, db, dh0), backward=True)
    return da, db, dh0


class RGLRUScanFn(torch.autograd.Function):
    """The scan with gradients on the card: the forward kernel, then the
    backward kernel. It saves a, the output h and h0 (b is not needed).
    Both kernels are deterministic, so a recompute under
    ``torch.utils.checkpoint`` reproduces h bit for bit. The backward takes
    fp32, so a and b must be fp32 (the model's coefficients are)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError(f"RGLRUScanFn: a {a.dtype} and b {b.dtype}; the scan trains "
                             "in fp32 only (its backward kernel takes fp32)")
        h, h_last = (rglru_scan_meta if a.is_meta else rglru_scan_cuda)(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.set_materialize_grads(False)
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        g = torch.zeros_like(h) if g is None else g.contiguous()
        g_last = None if g_last is None else g_last.contiguous()
        bwd = rglru_scan_bwd_meta if a.is_meta else rglru_scan_bwd_cuda
        da, db, dh0 = bwd(a, h, g, h0, g_last)
        return da, db, dh0
