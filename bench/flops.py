"""The yardstick's arithmetic: a step's model FLOPs from a configuration's
widths, the attention kernels' least time (a frozen copy of the bounds that
``chip_smoke.py`` states), and the card's published peaks.

Nothing here reads the program: every count comes from the configuration
file's own keys (``configs/<name>.json``, Hugging Face names) and the
traffic's batch and sequence length.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
PEAK_KIND = {"bfloat16": "bf16", "float16": "bf16", "float32": "fp32"}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def dims(cfg: dict) -> dict:
    """The widths a count needs, read from a configuration file's keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "h": h, "kv": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or d // h, "ff": cfg["intermediate_size"],
            "vocab": cfg["vocab_size"], "layers": cfg["num_hidden_layers"],
            "experts": cfg.get("num_local_experts", 0),
            "top_k": cfg.get("num_experts_per_tok", 0)}


def unmasked_pairs(sq, skv, causal, window, q_offset=0) -> int:
    """(query, key) pairs that the masks keep, per (batch, head)."""
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, int)
    return int(np.clip(hi - lo, 0, None).sum())


def forward_flops(cfg: dict, seq: int, pairs: int | None = None) -> dict:
    """One sequence's forward FLOPs by part, 2 a multiply-add: the
    projections, the attention products over ``pairs`` (query, key) pairs a
    head (the causal ones by default), the gated MLP or the router and
    ``top_k`` experts a token (not the capacity padding), and the tied
    unembedding. The embedding lookup, norms and elementwise work count 0."""
    w = dims(cfg)
    pairs = unmasked_pairs(seq, seq, True, 0) if pairs is None else pairs
    d, hd = w["d"], w["hd"]
    proj = 2 * d * hd * (w["h"] + 2 * w["kv"]) + 2 * w["h"] * hd * d
    attn = 4 * hd * w["h"] * pairs / seq
    if w["experts"]:
        ffn = 2 * d * w["experts"] + w["top_k"] * 6 * d * w["ff"]
    else:
        ffn = 6 * d * w["ff"]
    per_token = {"projections": w["layers"] * proj, "attention": w["layers"] * attn,
                 "ffn": w["layers"] * ffn, "unembed": 2 * d * w["vocab"]}
    return {k: v * seq for k, v in per_token.items()}


def train_flops_per_token(cfg: dict, seq: int, pairs: int | None = None) -> float:
    """Model FLOPs of a train step a token: 3 x the forward (the backward
    takes 2), with no recompute."""
    return 3 * sum(forward_flops(cfg, seq, pairs).values()) / seq


def bound(nbytes, flops, kind):
    """Least time on the card: the larger of the bytes over HBM bandwidth
    and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def attention_bound(b, h, kv, sq, d, causal, window, dtype, skv=None, q_offset=0):
    """The forward: q, k, v read once, o written once; 2 products of 2 FLOP
    per unmasked (query, key) pair and head dim."""
    skv = sq if skv is None else skv
    pairs = unmasked_pairs(sq, skv, causal, window, q_offset)
    nbytes = (2 * b * h * sq * d + 2 * b * kv * skv * d) * ITEMSIZE[dtype]
    return bound(nbytes, 4 * d * pairs * b * h, PEAK_KIND[dtype])


def attention_bwd_bound(b, h, kv, sq, d, causal, window, dtype, skv=None, q_offset=0):
    """The backward: q, o, do and dq, k, v, dk and dv once each and the fp32
    lse; 5 products (S, dP, dV, dQ, dK) of 2·D FLOP per unmasked pair and
    head."""
    skv = sq if skv is None else skv
    pairs = unmasked_pairs(sq, skv, causal, window, q_offset)
    nbytes = (4 * b * h * sq * d + 4 * b * kv * skv * d) * ITEMSIZE[dtype] + 4 * b * h * sq
    return bound(nbytes, 10 * d * pairs * b * h, PEAK_KIND[dtype])
