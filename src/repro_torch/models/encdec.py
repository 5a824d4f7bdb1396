"""Encoder-decoder model (whisper-tiny backbone).

The audio frontend (log-mel + conv downsampling) is the reference's stub:
the input is precomputed frame embeddings (B, enc_seq, d_model). Positions
are sinusoidal (whisper-style absolute), so any decode length is
shape-valid. The encoder's self-attention is bidirectional and the
decoder's causal: train and prefill run both through the flash kernel
(``kernels.ops.flash_attention``, with ``force``); the cross-attention over
the memory and decode attention are plain PyTorch, as in the reference.
Neither ``encode`` nor ``decode_train`` rematerializes, as the reference's
do not.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import params as prm
from repro_torch.nn.attention import (
    KVCache,
    cross_attention,
    def_cross_attention,
    def_gqa,
    gqa_attention,
)
from repro_torch.nn.layers import (
    def_norm,
    embed_lookup,
    norm,
    sinusoidal_positions,
    unembed,
)
from repro_torch.nn.mlp import def_mlp, mlp
from repro_torch.nn.policy import interior_einsum
from repro_torch.parallel import shard


def _def_enc_block(cfg: ModelConfig):
    return {
        "norm1": def_norm(cfg.d_model, cfg.rms_norm),
        "attn": def_gqa(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "norm2": def_norm(cfg.d_model, cfg.rms_norm),
        "mlp": def_mlp(cfg.d_model, cfg.d_ff, cfg.act),
    }


def def_encdec(cfg: ModelConfig):
    dec_block = {
        "norm1": def_norm(cfg.d_model, cfg.rms_norm),
        "attn": def_gqa(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "norm_cross": def_norm(cfg.d_model, cfg.rms_norm),
        "cross": def_cross_attention(cfg.d_model, cfg.n_heads, cfg.hd),
        "norm2": def_norm(cfg.d_model, cfg.rms_norm),
        "mlp": def_mlp(cfg.d_model, cfg.d_ff, cfg.act),
    }
    return {
        "embed": prm.embedding(cfg.vocab_size, cfg.d_model),
        "enc": [_def_enc_block(cfg) for _ in range(cfg.n_enc_layers)],
        "enc_norm": def_norm(cfg.d_model, cfg.rms_norm),
        "dec": [dict(dec_block) for _ in range(cfg.n_layers)],
        "dec_norm": def_norm(cfg.d_model, cfg.rms_norm),
    }


def encode(p, frames, cfg: ModelConfig, force=None):
    """frames: (B, enc_seq, d) stub frontend output → encoder memory in the
    frames' dtype (the positions are rounded to it before the add, so bf16
    frames keep the residual stream bf16 under fp32 weights, as in the
    reference)."""
    b, s, _ = frames.shape
    x = frames + sinusoidal_positions(s, cfg.d_model, device=frames.device).to(frames.dtype)
    x = shard(x, "batch", "enc_seq", "embed")
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for blk in p["enc"]:
        h = norm(blk["norm1"], x, cfg.rms_norm)
        o, _ = gqa_attention(blk["attn"], h, positions=positions, use_rope=False,
                             causal=False, mode="train", force=force)
        x = x + o
        x = x + mlp(blk["mlp"], norm(blk["norm2"], x, cfg.rms_norm), cfg.act)
        x = shard(x, "batch", "enc_seq", "embed")
    return norm(p["enc_norm"], x, cfg.rms_norm)


def decode_train(p, tokens, memory, cfg: ModelConfig, force=None):
    """Teacher-forced decoder pass. tokens: (B, S); memory: (B, S_enc, d).
    Returns the fp32 logits (B, S, V)."""
    b, s = tokens.shape
    x = embed_lookup(p["embed"], tokens).to(prm.torch_dtype(cfg.dtype))
    x = x + sinusoidal_positions(s, cfg.d_model, device=x.device).to(x.dtype)
    x = shard(x, "batch", "seq", "embed")
    positions = torch.arange(s, device=x.device).expand(b, s)
    for blk in p["dec"]:
        h = norm(blk["norm1"], x, cfg.rms_norm)
        o, _ = gqa_attention(blk["attn"], h, positions=positions, use_rope=False,
                             causal=True, mode="train", force=force)
        x = x + o
        h = norm(blk["norm_cross"], x, cfg.rms_norm)
        o, _ = cross_attention(blk["cross"], h, memory=memory)
        x = x + o
        x = x + mlp(blk["mlp"], norm(blk["norm2"], x, cfg.rms_norm), cfg.act)
        x = shard(x, "batch", "seq", "embed")
    x = norm(p["dec_norm"], x, cfg.rms_norm)
    return unembed(p["embed"], x)


def init_decode_state(p, memory, cfg: ModelConfig, batch: int, s_max: int,
                      dtype: torch.dtype):
    """Per decoder layer: a zeroed self-attention KV cache at capacity
    ``s_max`` and the cross-attention's K/V of ``memory`` (accumulated in
    fp32, then ``dtype``), all on the memory's device. ``dtype`` has no
    default (the reference's is bf16); ``ServeEngine`` passes the config's
    (ROADMAP C.15)."""
    shape = (batch, cfg.n_kv_heads, s_max, cfg.hd)
    states = []
    for blk in p["dec"]:
        k = interior_einsum("bsd,dhk->bhsk", memory, blk["cross"]["wk"], dtype)
        v = interior_einsum("bsd,dhk->bhsk", memory, blk["cross"]["wv"], dtype)
        states.append({
            "self": KVCache(torch.zeros(shape, dtype=dtype, device=memory.device),
                            torch.zeros(shape, dtype=dtype, device=memory.device)),
            "cross_kv": (k, v),
        })
    return states


def abstract_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                          dtype=torch.bfloat16):
    """``init_decode_state``'s leaves as ``params.ShapeDtype``, with no
    params, memory or allocation (the dry-run's)."""
    def sd(shape):
        return prm.ShapeDtype(shape, dtype)

    kv = (batch, cfg.n_kv_heads, s_max, cfg.hd)
    cross = (batch, cfg.n_heads, cfg.enc_seq, cfg.hd)
    return [{"self": KVCache(sd(kv), sd(kv)), "cross_kv": (sd(cross), sd(cross))}
            for _ in range(cfg.n_layers)]


def decode_state_axes(cfg: ModelConfig):
    """The decode state's logical axes, leaf for leaf (its shardings on a
    mesh)."""
    kv = ("batch", "kv_heads", "kv_seq", "head_dim")
    cross = ("batch", "heads", "enc_seq", "head_dim")
    return [{"self": KVCache(k=kv, v=kv), "cross_kv": (cross, cross)}
            for _ in range(cfg.n_layers)]


def decode_step(p, token, states, cache_len: int, cfg: ModelConfig):
    """One decode step. token: (B, 1); returns (logits (B, 1, V), states):
    each self-attention cache is written in place at ``cache_len``."""
    b = token.shape[0]
    x = embed_lookup(p["embed"], token).to(prm.torch_dtype(cfg.dtype))
    # the absolute position cache_len: the table's row, in fp32, one cast
    x = x + sinusoidal_positions(1, cfg.d_model, offset=cache_len,
                                 device=x.device).to(x.dtype)
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    new_states = []
    for blk, st in zip(p["dec"], states):
        h = norm(blk["norm1"], x, cfg.rms_norm)
        o, new_cache = gqa_attention(blk["attn"], h, positions=pos, use_rope=False,
                                     causal=True, cache=st["self"], cache_len=cache_len,
                                     mode="decode")
        x = x + o
        h = norm(blk["norm_cross"], x, cfg.rms_norm)
        o, _ = cross_attention(blk["cross"], h, mem_kv=st["cross_kv"])
        x = x + o
        x = x + mlp(blk["mlp"], norm(blk["norm2"], x, cfg.rms_norm), cfg.act)
        new_states.append({"self": new_cache, "cross_kv": st["cross_kv"]})
    x = norm(p["dec_norm"], x, cfg.rms_norm)
    return unembed(p["embed"], x), new_states
