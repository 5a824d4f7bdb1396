"""Decoder-only language model assembly."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import params as prm
from repro_torch.nn.blocks import def_stack, stack_apply
from repro_torch.nn.layers import def_rmsnorm, embed_lookup, rmsnorm, unembed


def def_lm(cfg: ModelConfig):
    d = {
        "embed": prm.embedding(cfg.vocab_size, cfg.d_model),
        "blocks": def_stack(cfg),
        "final_norm": def_rmsnorm(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        d["unembed"] = prm.ParamDef((cfg.vocab_size, cfg.d_model),
                                    ("vocab", "embed"), init="normal", scale=0.02)
    return d


def lm_apply(p, tokens, cfg: ModelConfig, *, mode="prefill", states=None,
             cache_len=None, force=None):
    """tokens: (B, S) integer → (logits (B, S, V) fp32, states). ``force``
    goes to the kernels' dispatchers (``kernels.ops``)."""
    b, s = tokens.shape
    if mode == "decode":
        positions = torch.full((b, s), cache_len, dtype=torch.long,
                               device=tokens.device)
    else:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_lookup(p["embed"], tokens).to(prm.torch_dtype(cfg.dtype))
    x, new_states = stack_apply(p["blocks"], x, cfg, positions=positions,
                                mode=mode, states=states, cache_len=cache_len,
                                force=force)
    x = rmsnorm(p["final_norm"], x)
    table = p["embed"] if cfg.tie_embeddings else p["unembed"]
    return unembed(table, x), new_states
