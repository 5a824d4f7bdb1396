"""Basic layers: embedding, norms, rotary embeddings, activations.

Functional like the reference: ``def_*`` builds ParamDef trees, the apply
functions take (params, inputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import params as prm


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x @ table.T → logits in fp32 (bf16 operands are
    exact in fp32, so this is the fp32-accumulated product)."""
    return torch.einsum("...d,vd->...v", x.float(), table.float())


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
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]
