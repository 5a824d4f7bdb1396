"""Per-layer blocks and the layer stack.

Block kinds (``cfg.block_pattern`` entries), all four of the reference's,
each with the config's norm (RMSNorm, or LayerNorm where ``rms_norm`` is
off) and MLP activation (SwiGLU for silu, an ungated MLP otherwise):
  * ``attn``  — GQA attention (with QKV bias or QK-norm where the arch has
    them) + dense MLP or MoE FFN
  * ``rglru`` — Griffin recurrent block (+ dense MLP)
  * ``mlstm`` — xLSTM matrix-LSTM block (its own up/down projections)
  * ``slstm`` — xLSTM scalar-LSTM block (its own gated FFN)

Two parameter layouts load, as in the reference: the stacked
``blocks/scan/...`` tree with a leading layers axis (``scan_layers`` with
a pure ``attn`` pattern) and the ``blocks/layers/<i>/...`` list, which
follows ``cfg.pattern_for_layers()``. The stacked layout runs as a Python
loop over its layers axis, each leaf unbound once (so under autograd its
gradient is one ``stack``, not a zero-filled ``select_backward`` a layer).

Train mode wraps each layer in the reference's remat policy
(``_remat_wrap``): ``torch.utils.checkpoint`` for ``"full"``, the same
with matmul outputs saved for ``"dots"``, nothing for ``"none"``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import params as prm
from repro_torch.nn.attention import KVCache, def_gqa, gqa_attention
from repro_torch.nn.layers import activation, def_norm, norm
from repro_torch.nn.mlp import def_mlp, mlp
from repro_torch.nn.moe import def_moe, moe_ffn
from repro_torch.nn.policy import interior_einsum
from repro_torch.nn.recurrent import (
    MLSTMState,
    SLSTMState,
    causal_conv,
    causal_conv_step,
    conv_state_init,
    def_causal_conv,
    def_rglru,
    def_slstm_core,
    mlstm_chunkwise,
    mlstm_state_init,
    mlstm_step,
    rglru,
    rglru_step,
    slstm_scan,
    slstm_state_init,
    slstm_step,
)
from repro_torch.parallel import current_env, shard, use_env
from repro_torch.parallel.sharding import batch_only, gather_dim, heads_whole, pin_grad
from repro_torch.utils.trees import (
    tree_flatten_with_paths,
    tree_map_with_path,
    tree_unflatten,
)


# --------------------------------------------------------------------------
# defs
# --------------------------------------------------------------------------

def def_attn_block(cfg: ModelConfig):
    d = {
        "norm1": def_norm(cfg.d_model, cfg.rms_norm),
        "attn": def_gqa(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.qkv_bias, cfg.qk_norm),
        "norm2": def_norm(cfg.d_model, cfg.rms_norm),
    }
    if cfg.is_moe:
        d["moe"] = def_moe(cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.top_k)
    else:
        d["mlp"] = def_mlp(cfg.d_model, cfg.d_ff, cfg.act)
    return d


def def_rglru_block(cfg: ModelConfig):
    w = cfg.lru_width or cfg.d_model
    return {
        "norm1": def_norm(cfg.d_model, cfg.rms_norm),
        "w_gate": prm.matrix(cfg.d_model, w, "embed", "lru"),
        "w_x": prm.matrix(cfg.d_model, w, "embed", "lru"),
        "conv": def_causal_conv(cfg.conv_width, w),
        "lru": def_rglru(w, cfg.n_heads),
        "w_out": prm.matrix(w, cfg.d_model, "lru", "embed"),
        "norm2": def_norm(cfg.d_model, cfg.rms_norm),
        "mlp": def_mlp(cfg.d_model, cfg.d_ff, cfg.act),
    }


def def_mlstm_block(cfg: ModelConfig):
    d, nh = cfg.d_model, cfg.n_heads
    di = 2 * d
    return {
        "norm": def_norm(d, cfg.rms_norm),
        "wu": prm.matrix(d, di, "embed", "lru"),
        "wg": prm.matrix(d, di, "embed", "lru"),
        "conv": def_causal_conv(cfg.conv_width, di),
        "wq": prm.matrix(di, di, "lru", None),
        "wk": prm.matrix(di, di, "lru", None),
        "wv": prm.matrix(di, di, "lru", None),
        "wi": prm.matrix(di, nh, "lru", "heads"),
        "bi": prm.bias(nh, "heads"),
        "wf": prm.matrix(di, nh, "lru", "heads"),
        "bf": prm.bias(nh, "heads"),
        "out_norm": prm.ParamDef((di,), ("lru",), init="ones", dtype="float32"),
        "wo": prm.matrix(di, d, "lru", "embed"),
    }


def def_slstm_block(cfg: ModelConfig):
    d, nh = cfg.d_model, cfg.n_heads
    return {
        "norm": def_norm(d, cfg.rms_norm),
        "conv": def_causal_conv(cfg.conv_width, d),
        "wi": prm.matrix(d, d, "embed", "lru"),
        "wf": prm.matrix(d, d, "embed", "lru"),
        "wz": prm.matrix(d, d, "embed", "lru"),
        "wo_g": prm.matrix(d, d, "embed", "lru"),
        "r": def_slstm_core(nh, d // nh),
        "out_norm": prm.ParamDef((d,), ("lru",), init="ones", dtype="float32"),
        "ffn": def_mlp(d, max(1, round(d * 4 / 3)), "silu"),
    }


_DEFS = {"attn": def_attn_block, "rglru": def_rglru_block,
         "mlstm": def_mlstm_block, "slstm": def_slstm_block}


def def_block(cfg: ModelConfig, kind: str):
    return _DEFS[kind](cfg)


# --------------------------------------------------------------------------
# state init (decode)
# --------------------------------------------------------------------------

def _kv_capacity(cfg: ModelConfig, s_max: int, compact: bool) -> int:
    """A KV cache's capacity: ``s_max``, or with ``compact`` a local-attention
    cache bounded at window + 1 (the reference's dry-run sizing, so that
    ``long_500k`` does not charge a local-attention arch a 500k cache).
    Executed serving keeps the full ``s_max``: decode indexes the cache by
    absolute position."""
    window = cfg.local_window
    return min(s_max, window + 1) if (window and compact) else s_max


def init_block_state(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     dtype=torch.bfloat16, device="cpu", compact: bool = False):
    """Zeroed decode state of one block. An attention block's KV cache is
    allocated at ``_kv_capacity`` (the full ``s_max`` unless ``compact``)."""
    if kind == "attn":
        shape = (batch, cfg.n_kv_heads, _kv_capacity(cfg, s_max, compact), cfg.hd)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"conv": conv_state_init(batch, cfg.conv_width, w, dtype, device),
                "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}
    if kind == "mlstm":
        di = 2 * cfg.d_model
        dh = di // cfg.n_heads
        return {"conv": conv_state_init(batch, cfg.conv_width, di, dtype, device),
                "state": mlstm_state_init(batch, cfg.n_heads, dh, dh, device)}
    if kind == "slstm":
        d = cfg.d_model
        return {"conv": conv_state_init(batch, cfg.conv_width, d, dtype, device),
                "state": slstm_state_init(batch, cfg.n_heads, d // cfg.n_heads, device)}
    raise ValueError(kind)


# --------------------------------------------------------------------------
# helpers of the recurrent blocks
# --------------------------------------------------------------------------

def _conv_history(u, width):
    """Prefill's conv state: the last width-1 *pre-conv* inputs (B, width-1,
    C), zeros before the prompt's start where it is shorter (ROADMAP C.7:
    the reference cannot slice them there)."""
    hist = u[:, -(width - 1):]
    short = width - 1 - hist.shape[1]
    if short <= 0:
        return hist
    zeros = torch.zeros((u.shape[0], short, u.shape[2]), dtype=u.dtype, device=u.device)
    return torch.cat([zeros, hist], dim=1)  # not F.pad: see nn.recurrent._shift


def _split_heads(t, n_heads):
    """(B, S, n_heads * dh) → (B, n_heads, S, dh); on a mesh the last dim
    is gathered first where its split does not keep the heads whole
    (``heads_whole``)."""
    b, s, _ = t.shape
    return heads_whole(t, 2, n_heads).reshape(b, s, n_heads, -1).transpose(1, 2)


def _heads(t, n_heads):
    """(B, n_heads * dh) → (B, n_heads, dh), as ``_split_heads``."""
    return heads_whole(t, 1, n_heads).reshape(t.shape[0], n_heads, -1)


def _group_rms(scale, x, n_heads, eps=1e-6):
    """x: (B, S, D) RMS-normalized in fp32 over each head's D/n_heads
    channels, times the fp32 ``scale``, back in x's dtype (xLSTM's output
    norm)."""
    b, s, dd = x.shape
    xh = heads_whole(x, 2, n_heads).reshape(b, s, n_heads, dd // n_heads).float()
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    y = pin_grad((xh * torch.rsqrt(var + eps)).reshape(b, s, dd)) * scale
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# block apply — mode in {train, prefill, decode}
# --------------------------------------------------------------------------

def apply_attn_block(p, x, cfg: ModelConfig, *, positions, mode="prefill",
                     state: Optional[KVCache] = None, cache_len=None,
                     force=None):
    """Returns (x, cache, aux); train returns no cache. aux is the MoE FFN's
    load-balancing loss, or None for a dense MLP. ``force`` goes to the
    flash kernel."""
    h = norm(p["norm1"], x, cfg.rms_norm)
    attn_out, new_cache = gqa_attention(
        p["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope, causal=True, window=cfg.local_window,
        cache=state, cache_len=cache_len, mode=mode, force=force)
    x = shard(x + attn_out, "batch", "seq", "embed")
    h = norm(p["norm2"], x, cfg.rms_norm)
    if cfg.is_moe:
        ffn_out, aux = moe_ffn(p["moe"], h, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor, act=cfg.act)
    else:
        ffn_out, aux = mlp(p["mlp"], h, cfg.act), None
    return shard(x + ffn_out, "batch", "seq", "embed"), new_cache, aux


def _check_mode(mode):
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")


def apply_rglru_block(p, x, cfg: ModelConfig, *, mode="prefill", state=None,
                      force=None):
    """Returns (x, {"conv": (B, width-1, W), "h": (B, W) fp32}), or (x,
    None) in train mode. Prefill's conv state is the last width-1 *pre-conv*
    inputs; ``force`` goes to the scan kernel. Train mode computes what
    prefill computes from no state and returns no state (the reference's
    ``apply_rglru_block``); under grad on the card its scan is
    ``RGLRUScanFn``."""
    _check_mode(mode)
    h = batch_only(norm(p["norm1"], x, cfg.rms_norm))
    gate = activation("gelu")(
        interior_einsum("bsd,dw->bsw", h, p["w_gate"]).float()).to(x.dtype)
    u = interior_einsum("bsd,dw->bsw", h, p["w_x"])
    if mode == "decode":
        u1, conv_state = causal_conv_step(p["conv"], u[:, 0], state["conv"])
        r, h_new = rglru_step(p["lru"], u1, state["h"], cfg.n_heads)
        r = r[:, None]
        new_state = {"conv": conv_state, "h": h_new}
    else:
        # --sp splits the sequence before lru can take the model axis, and
        # the scan runs on whole time: gathered here, as XLA gathers it
        xs = gather_dim(shard(causal_conv(p["conv"], u), "batch", "seq", "lru"), 1)
        r, h_last = rglru(p["lru"], xs, cfg.n_heads,
                          h0=state["h"] if state is not None else None,
                          force=force)
        new_state = None
        if mode == "prefill":
            new_state = {"conv": _conv_history(u, p["conv"]["w"].shape[0]), "h": h_last}
    x = x + batch_only(interior_einsum("bsw,wd->bsd", (r * gate).to(x.dtype), p["w_out"]))
    x = shard(x, "batch", "seq", "embed")
    x = x + mlp(p["mlp"], norm(p["norm2"], x, cfg.rms_norm), cfg.act)
    return shard(x, "batch", "seq", "embed"), new_state


def apply_mlstm_block(p, x, cfg: ModelConfig, *, mode="prefill", state=None):
    """Returns (x, {"conv": (B, width-1, 2D), "state": MLSTMState}), or (x,
    None) in train mode. q, k and the i/f gates come from the conv+SiLU
    output, v from the pre-conv ``u``; the forget gate's +3.0 is added in
    the model dtype, after the bias, as the reference adds it. Prefill runs
    ``mlstm_chunkwise`` at chunk ``min(attn_chunk, S)`` (which must divide
    S), decode ``mlstm_step``."""
    _check_mode(mode)
    nh = cfg.n_heads
    di = 2 * cfg.d_model
    h = norm(p["norm"], x, cfg.rms_norm)
    u = interior_einsum("bsd,de->bse", h, p["wu"])
    g = interior_einsum("bsd,de->bse", h, p["wg"])
    new_state = None
    if mode == "decode":
        c, conv_state = causal_conv_step(p["conv"], u[:, 0], state["conv"])
        c = F.silu(c.float()).to(x.dtype)
        q, k, v = (_heads(t, nh) for t in (c @ p["wq"], c @ p["wk"], u[:, 0] @ p["wv"]))
        ig = (batch_only(c @ p["wi"]) + p["bi"]).float()
        fg = (batch_only(c @ p["wf"]) + p["bf"] + 3.0).float()
        hout, mstate = mlstm_step(q, k, v, ig, fg, state["state"])
        hout = hout.reshape(-1, 1, di)
        new_state = {"conv": conv_state, "state": mstate}
    else:
        c = F.silu(causal_conv(p["conv"], u).float()).to(x.dtype)
        b, s, _ = c.shape
        q, k, v = (_split_heads(t, nh) for t in (c @ p["wq"], c @ p["wk"], u @ p["wv"]))
        # the gates' products summed over their split input before the bias
        # (DTensor 2.11 cannot add a split bias to a partial sum)
        ig = (batch_only(c @ p["wi"]) + p["bi"]).float().transpose(1, 2)
        fg = (batch_only(c @ p["wf"]) + p["bf"] + 3.0).float().transpose(1, 2)
        hout, mstate = mlstm_chunkwise(q, k, v, ig, fg,
                                       state["state"] if state is not None else None,
                                       chunk=min(cfg.attn_chunk, s))
        hout = pin_grad(hout.transpose(1, 2).reshape(b, s, di))
        if mode == "prefill":
            new_state = {"conv": _conv_history(u, p["conv"]["w"].shape[0]), "state": mstate}
    hout = _group_rms(p["out_norm"], hout, nh)
    y = (hout * F.silu(g.float()).to(x.dtype)) @ p["wo"]
    return shard(x + y.to(x.dtype), "batch", "seq", "embed"), new_state


def apply_slstm_block(p, x, cfg: ModelConfig, *, mode="prefill", state=None):
    """Returns (x, {"conv": (B, width-1, D), "state": SLSTMState}), or (x,
    None) in train mode. The i and f gates come from the conv+SiLU output,
    z and o from the normed input; the recurrence runs ``slstm_scan`` (one
    step a token) or, in decode, ``slstm_step``. Its FFN has no pre-norm."""
    _check_mode(mode)
    d, nh = cfg.d_model, cfg.n_heads
    h = norm(p["norm"], x, cfg.rms_norm)
    new_state = None
    if mode == "decode":
        c, conv_state = causal_conv_step(p["conv"], h[:, 0], state["conv"])
        c = F.silu(c.float()).to(x.dtype)
        gates = {"i": _heads(c @ p["wi"], nh), "f": _heads(c @ p["wf"], nh),
                 "z": _heads(h[:, 0] @ p["wz"], nh), "o": _heads(h[:, 0] @ p["wo_g"], nh)}
        hout, sstate = slstm_step(p["r"], gates, state["state"])
        hout = hout.reshape(-1, 1, d).to(x.dtype)
        new_state = {"conv": conv_state, "state": sstate}
    else:
        b, s, _ = h.shape
        c = F.silu(causal_conv(p["conv"], h).float()).to(x.dtype)
        gates = {"i": _split_heads(c @ p["wi"], nh), "f": _split_heads(c @ p["wf"], nh),
                 "z": _split_heads(h @ p["wz"], nh), "o": _split_heads(h @ p["wo_g"], nh)}
        hout, sstate = slstm_scan(p["r"], gates,
                                  state["state"] if state is not None else None)
        hout = pin_grad(hout.transpose(1, 2).reshape(b, s, d)).to(x.dtype)
        if mode == "prefill":
            new_state = {"conv": _conv_history(h, p["conv"]["w"].shape[0]), "state": sstate}
    x = x + _group_rms(p["out_norm"], hout, nh)
    return shard(x + mlp(p["ffn"], x, "silu"), "batch", "seq", "embed"), new_state


def apply_block(p, x, cfg: ModelConfig, kind: str, *, positions=None,
                mode="prefill", state=None, cache_len=None, force=None):
    """Returns (x, state, aux): aux as ``apply_attn_block``'s, None for a
    recurrent block (rglru, mlstm, slstm). ``force`` goes to the kernels,
    which only attn and rglru blocks reach."""
    if kind == "attn":
        return apply_attn_block(p, x, cfg, positions=positions, mode=mode,
                                state=state, cache_len=cache_len, force=force)
    if kind == "rglru":
        return (*apply_rglru_block(p, x, cfg, mode=mode, state=state, force=force), None)
    if kind == "mlstm":
        return (*apply_mlstm_block(p, x, cfg, mode=mode, state=state), None)
    if kind == "slstm":
        return (*apply_slstm_block(p, x, cfg, mode=mode, state=state), None)
    raise ValueError(kind)


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
    return {"layers": [def_block(cfg, k) for k in cfg.pattern_for_layers()]}


def _unstack(tree, n: int) -> list:
    """The n per-layer trees of a stacked tree, each leaf unbound once."""
    parts = [(path, t.unbind(0)) for path, t in tree_flatten_with_paths(tree)]
    return [tree_unflatten({path: ts[i] for path, ts in parts}) for i in range(n)]


# matmul outputs: what jax.checkpoint_policies.dots_saveable keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ModelConfig):
    """The reference's per-layer remat: nothing for ``"none"``, a
    non-reentrant ``torch.utils.checkpoint`` for ``"full"`` (the layer's
    forward runs again in the backward), the same keeping matmul outputs
    for ``"dots"``. The forward's mesh env goes with it: on the card the
    backward, recompute included, runs on autograd's device thread, whose
    env stack is its own (empty)."""
    if cfg.remat == "none":
        return fn
    env, inner = current_env(), fn

    def fn(*args):
        with use_env(env):
            return inner(*args)

    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be none, dots or full, got {cfg.remat!r}")


def _train_stack(p, x, cfg: ModelConfig, *, positions, force=None):
    """Train mode: every block under the remat policy. Returns (x, aux): aux
    is the sum of the MoE blocks' load-balancing losses, an fp32 scalar
    (zero for a dense stack)."""
    if _stackable(cfg):
        layer_ps = _unstack(p["scan"], cfg.n_layers)
        kinds = ("attn",) * cfg.n_layers
    else:
        layer_ps, kinds = p["layers"], cfg.pattern_for_layers()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer_p, kind in zip(layer_ps, kinds):
        def one(h, lp, kind=kind):
            y, _, a = apply_block(lp, h, cfg, kind, positions=positions, mode="train",
                                  force=force)
            return y, a

        x, a = _remat_wrap(one, cfg)(x, layer_p)
        if a is not None:
            aux = aux + a
    return x, aux


def stack_apply(p, x, cfg: ModelConfig, *, positions, mode="prefill",
                states=None, cache_len=None, force=None):
    """Run all decoder blocks. Returns (x, states); train returns (x, aux).

    Prefill returns fresh states (a list, or one stacked KVCache for the
    stacked layout); decode writes KV caches in place and returns the
    states, with each recurrent block's state dict replaced. ``force`` goes
    to both kernels (``kernels.ops``).
    """
    if mode == "train":
        return _train_stack(p, x, cfg, positions=positions, force=force)
    if _stackable(cfg):
        ks, vs = [], []
        for i, layer_p in enumerate(_unstack(p["scan"], cfg.n_layers)):
            st = KVCache(states.k[i], states.v[i]) if mode == "decode" else None
            x, cache, _ = apply_attn_block(layer_p, x, cfg, positions=positions,
                                           mode=mode, state=st, cache_len=cache_len,
                                           force=force)
            if mode == "prefill":
                ks.append(cache.k)
                vs.append(cache.v)
        if mode == "prefill":
            return x, KVCache(torch.stack(ks), torch.stack(vs))
        return x, states

    new_states = []
    for i, kind in enumerate(cfg.pattern_for_layers()):
        st = states[i] if states is not None else None
        x, state, _ = apply_block(p["layers"][i], x, cfg, kind, positions=positions,
                                  mode=mode, state=st, cache_len=cache_len,
                                  force=force)
        new_states.append(state)
    return x, new_states


def init_stack_state(cfg: ModelConfig, batch: int, s_max: int,
                     dtype=torch.bfloat16, device="cpu", compact: bool = False):
    """Decode-time state for the whole stack (stacked for scan models);
    ``compact`` as ``init_block_state``'s."""
    if _stackable(cfg):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, _kv_capacity(cfg, s_max, compact),
                 cfg.hd)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))
    return [init_block_state(cfg, kind, batch, s_max, dtype, device, compact)
            for kind in cfg.pattern_for_layers()]


# --------------------------------------------------------------------------
# logical axes of decode state (its shardings on a mesh)
# --------------------------------------------------------------------------

def block_state_axes(cfg: ModelConfig, kind: str):
    """The logical axes of one block's decode state, leaf for leaf."""
    if kind == "attn":
        kv = ("batch", "kv_heads", "kv_seq", "head_dim")
        return KVCache(k=kv, v=kv)
    if kind == "rglru":
        return {"conv": ("batch", None, "lru"), "h": ("batch", "lru")}
    if kind == "mlstm":
        return {"conv": ("batch", None, "lru"),
                "state": MLSTMState(c=("batch", "heads", None, None),
                                    n=("batch", "heads", None),
                                    m=("batch", "heads"))}
    if kind == "slstm":
        return {"conv": ("batch", None, "lru"),
                "state": SLSTMState(c=("batch", "heads", None),
                                    n=("batch", "heads", None),
                                    m=("batch", "heads", None),
                                    h=("batch", "heads", None))}
    raise ValueError(kind)


def stack_state_axes(cfg: ModelConfig):
    """The decode state's logical axes for the whole stack."""
    if _stackable(cfg):
        kv = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
        return KVCache(k=kv, v=kv)
    return [block_state_axes(cfg, k) for k in cfg.pattern_for_layers()]
