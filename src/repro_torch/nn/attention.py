"""GQA attention: train and prefill through the flash kernel, decode
against a KV cache; whisper's cross-attention over the encoder memory.

Train and prefill call ``kernels.ops.flash_attention``: the Hopper kernel
for a CUDA tensor (with grad on, its forward and backward kernels through
``FlashAttentionFn``), its plain version for a CPU one. This is where the
reference calls its chunked jnp twin of the Pallas kernel. Decode attention
and cross-attention have no kernel in the reference either and stay plain
PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.nn import params as prm
from repro_torch.nn.layers import apply_rope, def_headnorm, rmsnorm
from repro_torch.nn.policy import interior_einsum
from repro_torch.parallel import shard
from repro_torch.parallel.sharding import batch_heads, batch_only, gather_dim

NEG_INF = -1e30


def def_gqa(d_model, n_heads, n_kv_heads, head_dim, qkv_bias=False, qk_norm=False):
    d = {
        "wq": prm.ParamDef((d_model, n_heads, head_dim), ("embed", "heads", "head_dim"),
                           init="scaled_fan_in"),
        "wk": prm.ParamDef((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"),
                           init="scaled_fan_in"),
        "wv": prm.ParamDef((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"),
                           init="scaled_fan_in"),
        "wo": prm.ParamDef((n_heads, head_dim, d_model), ("heads", "head_dim", "embed"),
                           init="scaled_fan_in"),
    }
    if qkv_bias:
        d["bq"] = prm.ParamDef((n_heads, head_dim), ("heads", "head_dim"), init="zeros")
        d["bk"] = prm.ParamDef((n_kv_heads, head_dim), ("kv_heads", "head_dim"), init="zeros")
        d["bv"] = prm.ParamDef((n_kv_heads, head_dim), ("kv_heads", "head_dim"), init="zeros")
    if qk_norm:
        d["q_norm"] = def_headnorm(head_dim)
        d["k_norm"] = def_headnorm(head_dim)
    return d


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, n_kv, S_max, head_dim)
    v: torch.Tensor  # (B, n_kv, S_max, head_dim)


def _project(x, w, bias=None):
    """x (B, S, d) · w (d, heads, hd) → (B, heads, S, hd) in x's dtype. A
    bias (heads, hd) is added to the fp32-accumulated product before its one
    rounding to x's dtype, as the reference adds it to the fp32 product
    (``addmm``: cuBLAS adds it in the GEMM's fp32 epilogue)."""
    if bias is None:
        return interior_einsum("bsd,dhk->bhsk", x, w)
    b, s, d = x.shape
    _, heads, hd = w.shape
    y = torch.addmm(bias.reshape(-1), x.reshape(b * s, d), w.reshape(d, heads * hd))
    return y.view(b, s, heads, hd).permute(0, 2, 1, 3)


def _project_qkv(p, x, positions, rope_theta, use_rope=True):
    """x: (B, S, d) → q (B, H, S, hd), k/v (B, KV, S, hd), contiguous. The
    reference's order: the products, with the biases where the arch has
    them (qkv_bias), in x's dtype, then the per-head norms (qk_norm), then
    RoPE."""
    x = batch_only(x)
    q = _project(x, p["wq"], p.get("bq"))
    k = _project(x, p["wk"], p.get("bk"))
    v = _project(x, p["wv"], p.get("bv"))
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if use_rope:
        q = apply_rope(q, positions[:, None, :], rope_theta)
        k = apply_rope(k, positions[:, None, :], rope_theta)
    q = shard(q, "batch_attn", "heads", "attn_seq", "head_dim")
    k = shard(k, "batch_attn", "kv_heads", "attn_seq", "head_dim")
    v = shard(v, "batch_attn", "kv_heads", "attn_seq", "head_dim")
    return q.contiguous(), k.contiguous(), v.contiguous()


def _group_q(q, n_kv):
    """(B, H, S, D) → (B, KV, G, S, D) grouping query heads per kv head."""
    b, h, s, d = q.shape
    return q.reshape(b, n_kv, h // n_kv, s, d)


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Reference O(S^2)-memory attention with the reference model's
    rounding points (oracle for tests)."""
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    qg = _group_q(q, n_kv) * (d ** -0.5)
    s = torch.einsum("bkgsd,bkcd->bkgsc", qg.float(), k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    if causal:
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    if window > 0:
        s = s.masked_fill(q_pos[:, None] - k_pos[None, :] >= window, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgsc,bkcd->bkgsd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def _pick_chunk(s: int, want: int) -> int:
    """Largest divisor of s that is <= want (the reference twin's chunk: 500
    at whisper's 1500 frames)."""
    c = min(want, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0, chunk=512):
    """The reference model's attention (``repro/nn/attention.py:
    flash_attention``, the chunked twin of the Pallas kernel) with its
    rounding points: q.scale in q's dtype, scores fp32, the unnormalized
    probabilities rounded to v's dtype for P.V, m, l and the accumulator
    fp32, the same chunks and kv-chunk bounds (oracle for tests and for
    ``chip_smoke.py``'s bounds; the model's prefill calls the kernel)."""
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    cq, ck = _pick_chunk(sq, chunk), _pick_chunk(skv, chunk)
    qg = _group_q((q * (d ** -0.5)).to(q.dtype), n_kv)
    outs = []
    for i in range(sq // cq):
        qi = qg[:, :, :, i * cq:(i + 1) * cq].float()
        q_pos = q_offset + i * cq + torch.arange(cq, device=q.device)
        hi = skv // ck if not causal else min(skv // ck, (q_offset + (i + 1) * cq + ck - 1) // ck)
        lo = max(0, (q_offset + i * cq - window) // ck) if window > 0 else 0
        m = torch.full(qi.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros(qi.shape, device=q.device)
        for j in range(lo, hi):
            kj, vj = k[:, :, j * ck:(j + 1) * ck], v[:, :, j * ck:(j + 1) * ck]
            k_pos = j * ck + torch.arange(ck, device=q.device)
            ok = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                ok &= q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                ok &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.einsum("bkgsd,bkcd->bkgsc", qi, kj.float()).masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l = l * alpha + p_.sum(-1)
            pv = torch.einsum("bkgsc,bkcd->bkgsd", p_.to(v.dtype).float(), vj.float())
            o = o * alpha[..., None] + pv
            m = m_new
        o = (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)
        outs.append(o.reshape(b, h, cq, d))
    return torch.cat(outs, dim=2)


def decode_attention(q, cache: KVCache, cache_len: int, *, window=0):
    """Single-step attention against a KV cache.

    q: (B, H, 1, D); cache.k/v: (B, KV, S_max, D); ``cache_len`` valid
    entries (the new token's k/v already written at cache_len - 1). Scores
    are computed in the cache's dtype, the softmax in fp32. DTensors whose
    cache is whole along its sequence run on each rank's local (batch,
    heads) shards, as the flash kernel does (``ops.heads_local``); a cache
    split on its sequence (ctx_parallel) runs as DTensors, q's heads
    gathered first (DTensor 2.11 cannot split a split head axis into
    groups).
    """
    if isinstance(q, DTensor):
        if Shard(2) not in cache.k.placements:
            return ops.heads_local(q, cache.k, cache.v, lambda ql, kl, vl: decode_attention(
                ql, KVCache(kl, vl), cache_len, window=window), "decode_attention")
        q = gather_dim(q, 1)
    b, h, _, d = q.shape
    n_kv, s_max = cache.k.shape[1], cache.k.shape[2]
    qg = _group_q(q * (d ** -0.5), n_kv)
    s = torch.einsum("bkgsd,bkcd->bkgsc", qg, cache.k).float()  # (B,KV,G,1,S_max)
    pos = torch.arange(s_max, device=q.device)
    valid = pos < cache_len
    if window > 0:
        valid &= pos >= cache_len - window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgsc,bkcd->bkgsd", p.to(cache.v.dtype), cache.v)
    return o.reshape(b, h, 1, d).to(q.dtype)


def _write_local(cache: DTensor, new: DTensor, pos: int):
    """Write ``new`` (B, KV, 1, D) at position ``pos`` of the DTensor
    ``cache`` (B, KV, S_max, D), in place, into each rank's local shard:
    ``new`` is first placed as the cache is on batch and heads, and where
    the cache splits its sequence (ctx_parallel) only the rank that holds
    ``pos`` writes."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    want = tuple(Replicate() if p == Shard(2) else p for p in cache.placements)
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                          cache.placements)
    at = pos - offset[2]
    with torch.no_grad():
        new = new.redistribute(mesh, want).to_local()  # on every rank: a collective
        if 0 <= at < shape[2]:
            cache.to_local()[:, :, at] = new[:, :, 0]


def gqa_attention(
    p,
    x,
    *,
    positions,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    causal: bool = True,
    window: int = 0,
    cache: Optional[KVCache] = None,
    cache_len: Optional[int] = None,
    mode: str = "prefill",  # train | prefill | decode
    force: Optional[str] = None,
):
    """Full GQA attention block. Returns (y, cache_or_None): train keeps no
    cache.

    ``force`` is passed to ``kernels.ops.flash_attention`` for train and
    prefill.
    """
    q, k, v = _project_qkv(p, x, positions, rope_theta, use_rope)
    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and cache_len")
        # In place: the cache is preallocated at capacity, and this step's
        # k/v land at position cache_len; then attend cache_len+1 entries.
        if isinstance(cache.k, DTensor):
            _write_local(cache.k, k, cache_len)
            _write_local(cache.v, v, cache_len)
        else:
            cache.k[:, :, cache_len:cache_len + 1] = k
            cache.v[:, :, cache_len:cache_len + 1] = v
        new_cache = cache
        o = decode_attention(q, cache, cache_len + 1, window=window)
    elif mode in ("train", "prefill"):
        o = ops.flash_attention(q, k, v, causal=causal, window=window,
                                force=force)
        new_cache = KVCache(k, v) if mode == "prefill" else None
    else:
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    o = shard(o, "batch_attn", "heads", "attn_seq", "head_dim")
    y = batch_only(interior_einsum("bhsk,hkd->bsd", o, p["wo"]))
    return y, new_cache


# --------------------------------------------------------------------------
# Cross attention (whisper decoder → encoder memory)
# --------------------------------------------------------------------------

def def_cross_attention(d_model, n_heads, head_dim):
    return {
        "wq": prm.ParamDef((d_model, n_heads, head_dim), ("embed", "heads", "head_dim"),
                           init="scaled_fan_in"),
        "wk": prm.ParamDef((d_model, n_heads, head_dim), ("embed", "kv_heads", "head_dim"),
                           init="scaled_fan_in"),
        "wv": prm.ParamDef((d_model, n_heads, head_dim), ("embed", "kv_heads", "head_dim"),
                           init="scaled_fan_in"),
        "wo": prm.ParamDef((n_heads, head_dim, d_model), ("heads", "head_dim", "embed"),
                           init="scaled_fan_in"),
    }


def cross_attention(p, x, memory=None, mem_kv=None):
    """x: (B, S, d) queries against the encoder ``memory`` (B, S_enc, d) or
    its precomputed ``mem_kv`` = (k, v), each (B, H, S_enc, hd). Returns (y
    in x's dtype, (k, v)). Naive attention with the reference's rounding
    points: the projections accumulated in fp32 and rounded to x's dtype
    (a bf16 memory under fp32 weights is multiplied in fp32), fp32 scores
    and softmax, the probabilities in v's dtype for P.V. DTensors run on
    each rank's local (batch, heads) shards (``ops.heads_local``): DTensor
    would flatten a batch split over two mesh axes with heads for the
    products, whose sharding search takes minutes on a 3-D mesh."""
    q = interior_einsum("bsd,dhk->bhsk", batch_only(x), p["wq"])
    if mem_kv is None:
        memory = batch_only(memory)
        k = interior_einsum("bsd,dhk->bhsk", memory, p["wk"], x.dtype)
        v = interior_einsum("bsd,dhk->bhsk", memory, p["wv"], x.dtype)
    else:
        k, v = mem_kv
    if isinstance(q, DTensor):  # on local (batch, heads) shards, as decode attention
        k = batch_heads(k)
        q, v = (t.redistribute(k.device_mesh, k.placements) for t in (q, v))
        o = ops.heads_local(q, k, v, lambda ql, kl, vl: naive_attention(ql, kl, vl, causal=False),
                            "cross_attention")
    else:
        o = naive_attention(q, k, v, causal=False)
    return batch_only(interior_einsum("bhsk,hkd->bsd", o, p["wo"])), (k, v)
