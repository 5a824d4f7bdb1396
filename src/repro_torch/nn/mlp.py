"""Dense gated MLP (SwiGLU, llama family)."""

from __future__ import annotations

import torch

from repro_torch.nn import params as prm
from repro_torch.nn.layers import activation
from repro_torch.nn.policy import interior_einsum


def def_mlp(d_model: int, d_ff: int):
    return {
        "up": prm.matrix(d_model, d_ff, "embed", "mlp"),
        "down": prm.matrix(d_ff, d_model, "mlp", "embed"),
        "gate": prm.matrix(d_model, d_ff, "embed", "mlp"),
    }


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU; the activation and the gating product run in fp32. The
    reference keeps the up/gate products in fp32 until then; here they come
    back in x's dtype first, which adds one bf16 rounding (fp32 is exact)."""
    up = interior_einsum("...d,df->...f", x, p["up"])
    gate = interior_einsum("...d,df->...f", x, p["gate"])
    h = activation(act)(gate.float()) * up.float()
    return interior_einsum("...f,fd->...d", h.to(x.dtype), p["down"])
