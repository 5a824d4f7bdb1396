"""Dispatching wrappers: the Hopper kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor, the kernel's shape function for a meta
tensor (the dry-run's: it allocates what the kernel allocates, reports the
kernel's own cost to a counter, ``kernels.cost``, and computes nothing).

The model code calls these. ``force`` picks a path explicitly: ``"kernel"``
(raises on a CPU tensor) or ``"ref"`` (the plain version, on any device).
There is no fallback: a CUDA tensor reaches the kernel or an exception.
With grad on, flash attention on the card goes through
``FlashAttentionFn`` and the RG-LRU scan through ``RGLRUScanFn`` (each the
forward kernel, then its backward kernel); the plain versions carry
autograd on their own.

Under a mesh the inputs are DTensors, which the kernels cannot take (they
read ``data_ptr()``). The dispatchers then run on each rank's local shard:
``to_local()``, the kernel (or its autograd function) or the plain version
on the local tensors, then ``DTensor.from_local`` with the input's
placements, so the backward kernels run on local shards too. Flash
attention may be sharded on batch (dim 0) and heads (dim 1) only, the scan
on batch (dim 0) and width (dim 2) only; any other placement raises, and
nothing is gathered quietly. Where q's heads are sharded and the kv heads
are whole (2 kv heads on a 4-way axis stay replicated), each rank attends
its q heads to the kv heads of their own groups, sliced from the whole kv,
and their gradient is a partial sum over that axis.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    flash_attention_meta,
)
from repro_torch.kernels.rglru import (
    RGLRUScanFn,
    rglru_scan_bwd_cuda,
    rglru_scan_cuda,
    rglru_scan_meta,
)
from repro_torch.parallel.sharding import contiguous_stride

_FORCES = (None, "kernel", "ref")
_KERNELS = {"flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "rglru_scan": rglru_scan_cuda,
            "rglru_scan_bwd": rglru_scan_bwd_cuda}


def _plain(x, force) -> bool:
    """Whether the plain version runs: forced, or x lies on the CPU (neither
    on the card nor on the meta device, where the kernel's shape function
    stands in for it)."""
    if force not in _FORCES:
        raise ValueError(f"force must be one of {_FORCES}, got {force!r}")
    return force == "ref" or (force is None and not (x.is_cuda or x.is_meta))


def _placements(t, mesh, what):
    """t's placements with a size-1 mesh dim's read as Replicate; t must be
    a DTensor on ``mesh``, with no partial placement."""
    if not isinstance(t, DTensor) or t.device_mesh != mesh:
        raise TypeError(f"{what}: a DTensor input needs every input a DTensor on its mesh")
    out = tuple(Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(t.placements))
    if any(p.is_partial() for p in out):
        raise ValueError(f"{what}: partial placement {t.placements}; reduce it first")
    return out


def _check_dims(pl, allowed, what):
    for p in pl:
        if isinstance(p, Shard) and p.dim not in allowed:
            raise ValueError(f"{what}: sharded on dim {p.dim} {pl}; the kernel runs on "
                             f"local shards of dims {allowed} only and gathers nothing")


def heads_local(q, k, v, fn, what="attention"):
    """``fn(q, k, v)`` of DTensors on each rank's local shards (module doc):
    q (B, H, Sq, D) and k, v (B, KV, Skv, D) split on batch and heads only;
    returns fn's (B, H, Sq, D) output as a DTensor placed like q. Flash
    attention and decode attention run this way."""
    mesh = q.device_mesh
    qp = _placements(q, mesh, what)
    kp = _placements(k, mesh, what)
    if _placements(v, mesh, what) != kp:
        raise ValueError(f"{what}: k {k.placements} and v {v.placements} differ")
    _check_dims(qp, (0, 1), what)
    kv_grad, sliced = [], False
    for a, b in zip(qp, kp):
        if a == Shard(1) and b == Replicate():
            sliced = True
            kv_grad.append(Partial())
        elif a != b:
            raise ValueError(f"{what}: q {q.placements} and kv {k.placements} "
                             "are not sharded alike on batch and heads")
        else:
            kv_grad.append(b)
    if sliced and any(a == Shard(1) and b == Shard(1) for a, b in zip(qp, kp)):
        raise ValueError(f"{what}: kv heads sharded on some of q's head axes "
                         f"only: q {q.placements}, kv {k.placements}")
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
    if sliced:  # the kv heads of this rank's q heads' groups
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        (_, hl, _, _), (_, h0, _, _) = compute_local_shape_and_global_offset(
            q.shape, mesh, q.placements)
        group = q.shape[1] // k.shape[1]
        if hl % group == 0 and h0 % group == 0:
            lo, hi = h0 // group, (h0 + hl) // group
        elif group % hl == 0:
            lo, hi = h0 // group, h0 // group + 1
        else:
            raise ValueError(f"{what}: {hl} local q heads from {h0} straddle "
                             f"kv groups of {group}")
        kl, vl = kl[:, lo:hi], vl[:, lo:hi]
    o = fn(ql.contiguous(), kl.contiguous(), vl.contiguous())
    return DTensor.from_local(o, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=contiguous_stride(q.shape))


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    force: str | None = None):
    """GQA flash attention. force in {None, 'kernel', 'ref'}. On the card,
    with grad on and an input that requires grad, the output's grad_fn is
    ``FlashAttentionFn``, whose backward is the backward kernel. DTensors
    run on their local shards (module doc)."""
    if isinstance(q, DTensor):
        return heads_local(q, k, v, lambda *t: flash_attention(
            *t, causal=causal, window=window, q_offset=q_offset, force=force),
            "flash_attention")
    if _plain(q, force):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    fwd = flash_attention_meta if q.is_meta else flash_attention_cuda
    return fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)


def _scan_local(a, b, h0, force):
    """The scan of DTensors on their local shards (module doc): a and b
    (B, S, W) sharded alike on dims 0 and 2, h0 (B, W) as they are."""
    mesh = a.device_mesh
    ap = _placements(a, mesh, "rglru_scan")
    if _placements(b, mesh, "rglru_scan") != ap:
        raise ValueError(f"rglru_scan: a {a.placements} and b {b.placements} differ")
    _check_dims(ap, (0, 2), "rglru_scan")
    state_pl = tuple(Shard(1) if p == Shard(2) else p for p in ap)
    if h0 is not None and _placements(h0, mesh, "rglru_scan") != state_pl:
        raise ValueError(f"rglru_scan: h0 {h0.placements} is not sharded as a, b "
                         f"{a.placements}")
    h, h_last = rglru_scan(a.to_local(), b.to_local(),
                           None if h0 is None else h0.to_local(), force=force)
    b_, s, w = b.shape
    return (DTensor.from_local(h, mesh, ap, run_check=False, shape=b.shape, stride=b.stride()),
            DTensor.from_local(h_last, mesh, state_pl, run_check=False,
                               shape=(b_, w), stride=(w, 1)))


def rglru_scan(a, b, h0=None, *, force: str | None = None):
    """Linear recurrence h_t = a_t*h_{t-1} + b_t over axis 1. Returns
    (h in b's dtype, h_last fp32). force in {None, 'kernel', 'ref'}. On the
    card, with grad on and an input that requires grad, the outputs'
    grad_fn is ``RGLRUScanFn``, whose backward is the backward kernel.
    DTensors run on their local shards (module doc)."""
    if isinstance(a, DTensor):
        return _scan_local(a, b, h0, force)
    if _plain(a, force):
        return ref.rglru_scan_ref(a, b, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (a, b, h0)):
        return RGLRUScanFn.apply(a, b, h0)
    return (rglru_scan_meta if a.is_meta else rglru_scan_cuda)(a, b, h0)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
