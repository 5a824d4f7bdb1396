"""Decoder-only language model assembly and the training loss."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import params as prm
from repro_torch.nn.blocks import def_stack, stack_apply
from repro_torch.nn.layers import def_norm, embed_lookup, norm, unembed
from repro_torch.parallel import shard


def def_lm(cfg: ModelConfig):
    d = {
        "embed": prm.embedding(cfg.vocab_size, cfg.d_model),
        "blocks": def_stack(cfg),
        "final_norm": def_norm(cfg.d_model, cfg.rms_norm),
    }
    if not cfg.tie_embeddings:
        d["unembed"] = prm.ParamDef((cfg.vocab_size, cfg.d_model),
                                    ("vocab", "embed"), init="normal", scale=0.02)
    return d


def lm_apply(p, tokens, cfg: ModelConfig, *, mode="prefill", states=None,
             cache_len=None, force=None):
    """tokens: (B, S) integer → (logits (B, S, V) fp32, states); train mode
    returns (logits, aux), aux the stack's fp32 auxiliary loss (zero for a
    dense arch), and keeps no states. ``force`` goes to the kernels'
    dispatchers (``kernels.ops``)."""
    b, s = tokens.shape
    if mode == "decode":
        positions = torch.full((b, s), cache_len, dtype=torch.long,
                               device=tokens.device)
    else:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_lookup(p["embed"], tokens).to(prm.torch_dtype(cfg.dtype))
    x = shard(x, "batch", "seq", "embed")
    x, new_states = stack_apply(p["blocks"], x, cfg, positions=positions,
                                mode=mode, states=states, cache_len=cache_len,
                                force=force)
    x = norm(p["final_norm"], x, cfg.rms_norm)
    table = p["embed"] if cfg.tie_embeddings else p["unembed"]
    logits = shard(unembed(table, x), "batch", "seq", "vocab")
    return logits, new_states


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Mean token cross-entropy in fp32 with the z-loss regularizer.

    logits: (B, S, V); labels: (B, S) integer, -1 masked out. The gold logit
    is gathered at max(label, 0); the mean is over unmasked tokens (at
    least 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = _gold_logit(logits, labels.clamp(min=0).long())
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom


def _gold_logit(logits, labels):
    """logits[..., label] of (B, S, V) logits and (B, S) labels. On a mesh
    the vocab is gathered first (DTensor's gather along a vocab-sharded dim
    takes a masked partial path that fails on these shapes) and the gather
    runs on each rank's local shards, labels placed as the logits: DTensor's
    own gather would take its backward through a zero tensor of the global
    (B, S, V) on every rank (206 GB of fp32 at smollm-360m's train_4k on
    16x16, found by the dry-run)."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh = logits.device_mesh
    whole = tuple(Replicate() if p == Shard(logits.dim() - 1) else p
                  for p in logits.placements)
    logits = logits.redistribute(mesh, whole)
    labels = labels.redistribute(mesh, whole)
    gold = torch.gather(logits.to_local(), -1, labels.to_local()[..., None])[..., 0]
    return DTensor.from_local(gold, mesh, whole, run_check=False, shape=labels.shape,
                              stride=labels.stride())
