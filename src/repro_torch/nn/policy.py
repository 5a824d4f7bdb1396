"""Matmul precision policy.

Interior products (projections, MLP) accumulate in fp32 and are then cast
back to the residual dtype; fp32 is kept where it matters (logits, softmax
internals, RMS norms).

PyTorch's bf16 GEMMs already work that way: on the card cuBLAS accumulates
in fp32 and rounds the result once (``ServeEngine`` turns off the
reduced-precision split-K reduction that would otherwise be allowed), and
on the CPU the bf16 GEMM accumulates in fp32 too. So an interior product
runs in its operands' dtype, with no fp32 copy of the weights. An fp32
product (the logits, the MoE router) stays fp32 on the card: PyTorch keeps
``torch.backends.cuda.matmul.allow_tf32`` off by default, and nothing in the
port turns it on.
"""

from __future__ import annotations

import torch


def interior_pref() -> torch.dtype:
    """Accumulation dtype of interior products."""
    return torch.float32


def interior_einsum(eq: str, x: torch.Tensor, w: torch.Tensor,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """``einsum`` accumulated in ``interior_pref()``, result in ``dtype``
    (x's by default). Operands of two dtypes (whisper's bf16 frames through
    fp32 weights) are multiplied in the wider one, as JAX promotes them, and
    so is a result wider than both; one dtype throughout is one product in
    it, with no copy and no cast."""
    out = x.dtype if dtype is None else dtype
    if x.dtype == w.dtype == out:
        return torch.einsum(eq, x, w)
    wide = torch.promote_types(torch.promote_types(x.dtype, w.dtype), out)
    return torch.einsum(eq, x.to(wide), w.to(wide)).to(out)
