"""Attention blocks and the layer stack.

Two parameter layouts load, as in the reference: the stacked
``blocks/scan/...`` tree with a leading layers axis (``scan_layers``, the
full config) and the ``blocks/layers/<i>/...`` list (the tiny config). The
stacked layout runs as a Python loop over its layers axis. Only ``attn``
blocks with a dense MLP are ported so far.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import params as prm
from repro_torch.nn.attention import KVCache, def_gqa, gqa_attention
from repro_torch.nn.layers import def_rmsnorm, rmsnorm
from repro_torch.nn.mlp import def_mlp, mlp
from repro_torch.utils.trees import tree_map_with_path


def _check_ported(cfg: ModelConfig):
    unported = []
    if set(cfg.pattern_for_layers()) != {"attn"}:
        unported.append(f"block pattern {cfg.block_pattern}")
    if cfg.is_moe:
        unported.append("MoE")
    if cfg.is_encoder_decoder:
        unported.append("encoder-decoder")
    if not cfg.rms_norm:
        unported.append("layernorm")
    if cfg.act != "silu":
        unported.append(f"{cfg.act} MLP")
    if cfg.qkv_bias or cfg.qk_norm:
        unported.append("qkv bias / qk norm")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet (see ROADMAP.md)")


def def_attn_block(cfg: ModelConfig):
    _check_ported(cfg)
    return {
        "norm1": def_rmsnorm(cfg.d_model),
        "attn": def_gqa(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "norm2": def_rmsnorm(cfg.d_model),
        "mlp": def_mlp(cfg.d_model, cfg.d_ff),
    }


def init_block_state(cfg: ModelConfig, batch: int, s_max: int,
                     dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (batch, cfg.n_kv_heads, s_max, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def apply_attn_block(p, x, cfg: ModelConfig, *, positions, mode="prefill",
                     state: Optional[KVCache] = None, cache_len=None,
                     attn_force=None):
    """Returns (x, cache)."""
    h = rmsnorm(p["norm1"], x)
    attn_out, new_cache = gqa_attention(
        p["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope, causal=True, window=cfg.local_window,
        cache=state, cache_len=cache_len, mode=mode, force=attn_force)
    x = x + attn_out
    x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x), cfg.act)
    return x, new_cache


# --------------------------------------------------------------------------
# layer stack
# --------------------------------------------------------------------------

def _stackable(cfg: ModelConfig) -> bool:
    return cfg.scan_layers and len(set(cfg.block_pattern)) == 1 \
        and cfg.block_pattern[0] == "attn"


def def_stack(cfg: ModelConfig):
    """Def-tree for the full stack of decoder blocks."""
    if _stackable(cfg):
        def add_layer_axis(_, d: prm.ParamDef) -> prm.ParamDef:
            return prm.ParamDef((cfg.n_layers,) + tuple(d.shape),
                                ("layers",) + tuple(d.axes),
                                init=d.init, scale=d.scale, dtype=d.dtype)

        return {"scan": tree_map_with_path(add_layer_axis, def_attn_block(cfg))}
    return {"layers": [def_attn_block(cfg) for _ in range(cfg.n_layers)]}


def stack_apply(p, x, cfg: ModelConfig, *, positions, mode="prefill",
                states=None, cache_len=None, attn_force=None):
    """Run all decoder blocks. Returns (x, states).

    Prefill returns fresh caches (a list, or one stacked KVCache for the
    stacked layout); decode writes ``states`` in place and returns it.
    """
    if _stackable(cfg):
        ks, vs = [], []
        for i in range(cfg.n_layers):
            layer_p = tree_map_with_path(lambda _, t: t[i], p["scan"])
            st = KVCache(states.k[i], states.v[i]) if mode == "decode" else None
            x, cache = apply_attn_block(layer_p, x, cfg, positions=positions,
                                        mode=mode, state=st, cache_len=cache_len,
                                        attn_force=attn_force)
            if mode == "prefill":
                ks.append(cache.k)
                vs.append(cache.v)
        if mode == "prefill":
            return x, KVCache(torch.stack(ks), torch.stack(vs))
        return x, states

    new_states = []
    for i, layer_p in enumerate(p["layers"]):
        st = states[i] if states is not None else None
        x, cache = apply_attn_block(layer_p, x, cfg, positions=positions,
                                    mode=mode, state=st, cache_len=cache_len,
                                    attn_force=attn_force)
        new_states.append(cache)
    return x, new_states


def init_stack_state(cfg: ModelConfig, batch: int, s_max: int,
                     dtype=torch.bfloat16, device="cpu"):
    """Decode-time state for the whole stack (stacked for scan models)."""
    if _stackable(cfg):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, s_max, cfg.hd)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))
    return [init_block_state(cfg, batch, s_max, dtype, device)
            for _ in range(cfg.n_layers)]
