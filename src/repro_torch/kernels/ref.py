"""Plain PyTorch versions of the port's kernels: the CPU path, and the
versions ``chip_smoke.py`` holds each kernel against on the card."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """O(S^2)-memory GQA attention.

    q: (B, H, Sq, D); k/v: (B, KV, Skv, D). fp32 softmax, output in q.dtype.
    """
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    group = h // n_kv
    qg = q.reshape(b, n_kv, group, sq, d).float() * (d ** -0.5)
    s = torch.einsum("bkgsd,bkcd->bkgsc", qg, k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    if causal:
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    if window > 0:
        s = s.masked_fill(q_pos[:, None] - k_pos[None, :] >= window, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgsc,bkcd->bkgsd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


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
