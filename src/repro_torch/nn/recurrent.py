"""Recurrent sequence mixers: the RG-LRU of RecurrentGemma/Griffin, with
its causal depthwise conv and block-diagonal gate projections.

The parallel RG-LRU calls ``kernels.ops.rglru_scan``: the Hopper scan
kernel for a CUDA tensor, its plain version for a CPU one. This is where
the reference runs ``jax.lax.associative_scan`` (its Pallas scan is reached
only from its kernel tests). In training (grad on) the kernel's outputs
carry ``RGLRUScanFn``, whose backward is the port's reverse-scan kernel;
the reference differentiates its associative scan. Decode takes one O(1)
step and stays plain PyTorch. mLSTM and sLSTM (xLSTM) are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn import params as prm


# --------------------------------------------------------------------------
# Causal depthwise conv1d (width w)
# --------------------------------------------------------------------------

def def_causal_conv(width, channels):
    return {
        "w": prm.ParamDef((width, channels), ("conv", "lru"), init="scaled_fan_in"),
        "b": prm.bias(channels, "lru"),
    }


def causal_conv(p, x):
    """x: (B, S, C) → same shape; causal depthwise conv, width = p.w.shape[0].
    Accumulated in fp32 (tap j sees x shifted j steps back), bias in fp32."""
    width, s = p["w"].shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(width):
        xj = F.pad(x, (0, 0, j, 0))[:, :s]
        out = out + xj.float() * p["w"][width - 1 - j].float()
    out = out + p["b"].float()
    return out.to(x.dtype)


def causal_conv_step(p, x_t, state):
    """x_t: (B, C); state: (B, width-1, C) past inputs. Returns (y_t, state')."""
    window = torch.cat([state, x_t[:, None]], dim=1)  # (B, width, C)
    y = torch.einsum("bwc,wc->bc", window.float(), p["w"].float()) + p["b"].float()
    return y.to(x_t.dtype), window[:, 1:]


def conv_state_init(batch, width, channels, dtype, device="cpu"):
    return torch.zeros((batch, width - 1, channels), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Block-diagonal linear (Griffin's gate projections)
# --------------------------------------------------------------------------

def def_blockdiag(n_blocks, block_w, n_out_per_block=None):
    out_w = n_out_per_block or block_w
    return {
        "w": prm.ParamDef((n_blocks, block_w, out_w), ("heads", "lru", None),
                          init="scaled_fan_in"),
        "b": prm.ParamDef((n_blocks, out_w), ("heads", None), init="zeros"),
    }


def blockdiag(p, x):
    """x: (..., n_blocks, block_w) → (..., n_blocks, out_w), computed in fp32
    and rounded to x's dtype, as the reference does."""
    y = torch.einsum("...nb,nbo->...no", x.float(), p["w"].float())
    return (y + p["b"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

_RG_C = 8.0  # Griffin's fixed exponent scale
_LAMBDA_SHIFT = -5.0  # softplus(raw - 5) ≈ 0.0067 → a ≈ 0.95 at r=1


def def_rglru(width, n_heads):
    block_w = width // n_heads
    return {
        "a_gate": def_blockdiag(n_heads, block_w),
        "i_gate": def_blockdiag(n_heads, block_w),
        "lam": prm.ParamDef((width,), ("lru",), init="zeros", dtype="float32"),
    }


def _rglru_coeffs(p, x, n_heads):
    """x: (B, S, W) → log_a (B,S,W) fp32, gated input b (B,S,W) fp32."""
    b_, s, w = x.shape
    xh = x.reshape(b_, s, n_heads, w // n_heads)
    r = torch.sigmoid(blockdiag(p["a_gate"], xh).float()).reshape(b_, s, w)
    i = torch.sigmoid(blockdiag(p["i_gate"], xh).float()).reshape(b_, s, w)
    log_a = -_RG_C * F.softplus(p["lam"] + _LAMBDA_SHIFT) * r
    gated_x = i * x.float()
    # sqrt(1 - a^2) input normalizer (Griffin eq. 4), computed from log_a.
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, multiplier * gated_x


def rglru(p, x, n_heads, h0=None, force=None):
    """Parallel RG-LRU over a sequence. x: (B,S,W) → (y (B,S,W) in x's dtype,
    h_last (B,W) fp32). ``force`` goes to ``kernels.ops.rglru_scan``. Under
    grad it differentiates through the scan: its plain version's autograd
    on the CPU, ``RGLRUScanFn`` on the card (a and b are fp32 here, as the
    backward kernel takes them)."""
    log_a, b = _rglru_coeffs(p, x, n_heads)
    h0 = None if h0 is None else h0.float().contiguous()
    h, h_last = ops.rglru_scan(torch.exp(log_a), b, h0, force=force)
    return h.to(x.dtype), h_last


def rglru_step(p, x_t, h, n_heads):
    """One decode step. x_t: (B, W); h: (B, W) fp32 state."""
    log_a, b = _rglru_coeffs(p, x_t[:, None], n_heads)
    h_new = torch.exp(log_a[:, 0]) * h + b[:, 0]
    return h_new.to(x_t.dtype), h_new


def rglru_ref(p, x, n_heads, h0=None):
    """Step-by-step oracle."""
    log_a, b = _rglru_coeffs(p, x, n_heads)
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    hs = []
    for t in range(x.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)
