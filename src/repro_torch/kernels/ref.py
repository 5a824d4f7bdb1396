"""Plain PyTorch versions of the port's kernels: the CPU path, and the
versions ``chip_smoke.py`` holds each kernel against on the card."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, causal, window, q_offset):
    """Masked fp32 scores (B, KV, G, Sq, Skv) of q scaled by d^-0.5."""
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, sq, d).float() * (d ** -0.5)
    s = torch.einsum("bkgsd,bkcd->bkgsc", qg, k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    if causal:
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    if window > 0:
        s = s.masked_fill(q_pos[:, None] - k_pos[None, :] >= window, NEG_INF)
    return s


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        return_lse=False):
    """O(S^2)-memory GQA attention.

    q: (B, H, Sq, D); k/v: (B, KV, Skv, D). fp32 softmax, output in q.dtype.
    With ``return_lse`` also the fp32 row logsumexp of the masked scaled
    scores, (B, H, Sq), in natural-log units: what the backward recomputes
    the probabilities from.
    """
    b, h, sq, d = q.shape
    s = _scores(q, k, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgsc,bkcd->bkgsd", p, v.float())
    o = o.reshape(b, h, sq, d).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=0,
                            q_offset=0):
    """The attention backward by its explicit formulas (not by autograd), in
    fp32: P = exp(S - lse) recomputed from the forward's logsumexp, Δ =
    rowsum(dO∘O) from the stored output, dV = Pᵀ·dO, dP = dO·Vᵀ, dS =
    P∘(dP − Δ), dQ = dS·K·scale, dK = dSᵀ·Q·scale; a GQA group's query
    heads are summed into their kv head's dK and dV. Returns (dq, dk, dv)
    in the inputs' dtypes."""
    b, h, sq, d = q.shape
    n_kv = k.shape[1]
    g = h // n_kv
    scale = d ** -0.5
    group = lambda t: t.reshape(b, n_kv, g, sq, d).float()  # noqa: E731
    qg, og, dog = group(q), group(o), group(do)
    kf, vf = k.float(), v.float()
    s = _scores(q, k, causal, window, q_offset)
    p = torch.exp(s - lse.reshape(b, n_kv, g, sq, 1).float())
    delta = (dog * og).sum(-1, keepdim=True)
    dv = torch.einsum("bkgsc,bkgsd->bkcd", p, dog)
    dp = torch.einsum("bkgsd,bkcd->bkgsc", dog, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgsc,bkcd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgsc,bkgsd->bkcd", ds, qg) * scale
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rglru_scan_ref(a, b, h0=None):
    """Step-by-step linear recurrence h_t = a_t * h_{t-1} + b_t.

    a, b: (B, S, W); h0: (B, W) or None. The loop runs in fp32. Returns
    (h (B, S, W) in b.dtype, h_last (B, W) fp32).
    """
    af, bf = a.float(), b.float()
    h = torch.zeros_like(bf[:, 0]) if h0 is None else h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(b.dtype), h


def rglru_scan_bwd_ref(a, h, g, h0=None, g_last=None):
    """The scan's backward by a reverse loop in fp32: the gradients of
    ``rglru_scan_ref`` given its output h, the gradient g of h and the
    gradient g_last of h_last (None: zero).

    a, h, g: (B, S, W); h0, g_last: (B, W) or None. With dh_t the gradient
    that reaches h_t:
      dh_{S-1} = g_{S-1} + g_last,  dh_t = g_t + a_{t+1}·dh_{t+1}
      da_t = dh_t·h_{t-1} (h_{-1} = h0, or 0),  db_t = dh_t,  dh0 = a_0·dh_0
    each product rounded, then the add: the order the kernel keeps, bit for
    bit. Returns (da, db (B, S, W) fp32, dh0 (B, W) fp32 or None without
    h0)."""
    af, hf, gf = a.float(), h.float(), g.float()
    h_prev = torch.zeros_like(hf[:, 0]) if h0 is None else h0.float()
    carry = None if g_last is None else g_last.float()
    da, db = torch.empty_like(gf), torch.empty_like(gf)
    for t in reversed(range(a.shape[1])):
        dh = gf[:, t] if carry is None else gf[:, t] + carry
        db[:, t] = dh
        da[:, t] = dh * (hf[:, t - 1] if t > 0 else h_prev)
        carry = af[:, t] * dh
    return da, db, (None if h0 is None else carry)
