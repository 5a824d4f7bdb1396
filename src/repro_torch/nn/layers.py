"""Basic layers: embedding, norms, rotary and sinusoidal positions,
activations.

Functional like the reference: ``def_*`` builds ParamDef trees, the apply
functions take (params, inputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.nn import params as prm
from repro_torch.parallel.sharding import batch_only


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table``. A DTensor table sharded over its vocab is
    gathered first: DTensor's masked lookup of a vocab shard gives a partial
    result whose gradient it cannot route back."""
    if isinstance(table, DTensor) and Shard(0) in table.placements:
        whole = tuple(Replicate() if p == Shard(0) else p for p in table.placements)
        table = table.redistribute(table.device_mesh, whole)
    return F.embedding(ids, table)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x @ table.T → logits in fp32 (bf16 operands are
    exact in fp32, so this is the fp32-accumulated product)."""
    return torch.einsum("...d,vd->...v", batch_only(x).float(), table.float())


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def def_rmsnorm(d):
    return {"scale": prm.norm_scale(d)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def def_layernorm(d):
    return {"scale": prm.norm_scale(d),
            "bias": prm.ParamDef((d,), ("embed",), init="zeros", dtype="float32")}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias in fp32, then x's dtype
    (the reference's formula, not ``F.layer_norm``: the same rounding
    points on every device)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def def_norm(d, rms=True):
    return def_rmsnorm(d) if rms else def_layernorm(d)


def norm(p, x: torch.Tensor, rms=True) -> torch.Tensor:
    return rmsnorm(p, x) if rms else layernorm(p, x)


# Per-head norm of the qk-norm archs (qwen3, chameleon): normalizes head_dim.
def def_headnorm(head_dim):
    return {"scale": prm.ParamDef((head_dim,), ("head_dim",), init="ones",
                                  dtype="float32")}


# --------------------------------------------------------------------------
# Rotary position embeddings (half-split rotation)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: (..., seq) integer."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if isinstance(x, DTensor) and not isinstance(cos, DTensor):
        # replicated DTensors, not plain constants: the product's backward
        # meets them in autograd's thread, where no env lets them mix
        whole = [Replicate()] * x.device_mesh.ndim
        cos, sin = (DTensor.from_local(t, x.device_mesh, whole, run_check=False)
                    for t in (cos, sin))
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """The classic transformer table (whisper's absolute positions), (seq,
    d_model) fp32: sin in the even columns, cos in the odd ones, of
    position / 10000^(2i / d_model) for positions offset .. offset+seq-1,
    each step in fp32 as the reference takes it. The power is taken in fp64
    and rounded once to fp32: correctly rounded, as XLA's fp32 power gives
    it, where torch's fp32 ``pow`` is an ulp off on some exponents."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, (dim / d_model).double()).float()
    emb = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(angle)
    emb[:, 1::2] = torch.cos(angle)
    return emb


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]
