"""A plain decoder-only LM train step in fp32 PyTorch: forward, loss,
gradients by autograd and AdamW, for a dense (SwiGLU) or MoE configuration
file of ``bench/configs``. It imports nothing of the program under test.

Written from the published llama / Granite-MoE descriptions and the port's
documented semantics, with TF32 off (the caller sets it). The model:

- token embedding; N blocks of RMSNorm -> GQA attention with half-split
  RoPE (theta ``rope_theta``), causal, scaled 1/sqrt(head_dim), query head h
  reading kv head h // (heads / kv heads) -> residual -> RMSNorm -> SwiGLU
  MLP or MoE -> residual; a final RMSNorm; the tied unembedding.
- RMSNorm: x * rsqrt(mean(x^2) + ``rms_norm_eps``) * scale.
- MoE: fp32 router logits, softmax, top-k, the k weights renormalized to sum
  1; per expert a capacity C = ceil(T*k/E*``capacity_factor``), at least 4
  and at most T*k; the (token, choice) rows routed to an expert are taken in
  their flat order (token-major) and rows past its first C are dropped
  (weight 0); each kept row through the expert's SwiGLU, weighted, summed
  over a token's k choices. Its load-balance loss is E * mean_e(share of
  tokens whose top choice is e * mean router probability of e), summed over
  layers, weighted ``router_aux_loss_coef``.
- Loss: mean over tokens of logsumexp - gold logit + ``z_loss`` *
  logsumexp^2, plus the weighted load-balance loss.
- AdamW: the global gradient norm clipped to ``clip_norm``, linear warmup
  then cosine decay to ``min_lr_frac`` of ``lr``, bias-corrected moments,
  decoupled weight decay on every leaf but the final norm's scale (unless
  ``decay_vectors``; and the layers' norm scales where
  ``layer_norm_scales_decay`` is false).

Departures from the published models, as the configuration files list
them: Granite's embedding, residual, attention and logits multipliers are
not modelled; no dropout; the capacity drop; the z-loss; the port's aux
weight and RMSNorm epsilon.

``quant=True`` rounds both operands of every product (projections,
attention's two products, the router, the experts, the unembedding) to fp8
e4m3 with a per-tensor scale, gradients passed straight through: the
benchmark's control, one precision below the bf16 the configurations state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.flops import dims
from bench.weights import draw, gather, kinds, sample_index, whole_shape

FP8_MAX = 448.0


def q8(x):
    """x rounded to fp8 e4m3 under a per-tensor scale; gradient straight
    through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    xq = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (xq - x.detach())


def mm(a, b, quant=False):
    return q8(a) @ q8(b) if quant else a @ b


# -------------------------------------------------------------------------
# parameters
# -------------------------------------------------------------------------

def ref_shape(cfg: dict, kind: str) -> tuple:
    """A kind's shape in the reference's layout (heads folded into one axis)."""
    w = dims(cfg)
    d, h, kv, hd = w["d"], w["h"], w["kv"], w["hd"]
    folded = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    if kind in folded:
        return (w["layers"], *folded[kind])
    return whole_shape(cfg, kind)


def layered(cfg: dict, kind: str) -> bool:
    return kinds(cfg)[kind][1] is not None


def init(cfg: dict, seed: int, device) -> dict:
    """The seeded weights in fp32: {kind: leaf} for a whole-model kind,
    {kind: [leaf a layer]} for a layer's, each leaf requiring grad."""
    params = {}
    for kind in kinds(cfg):
        t = draw(cfg, kind, seed, device).float().view(ref_shape(cfg, kind))
        if layered(cfg, kind):
            params[kind] = [x.clone().requires_grad_(True) for x in t.unbind(0)]
        else:
            params[kind] = t.requires_grad_(True)
    return params


def leaves(params: dict) -> list:
    """[(kind, leaf)] in a fixed order."""
    out = []
    for kind, v in params.items():
        out.extend((kind, t) for t in (v if isinstance(v, list) else [v]))
    return out


# -------------------------------------------------------------------------
# forward
# -------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, heads, S, hd): the half-split rotation by position."""
    s, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# scores held at once by the attention, in elements (1 GiB of fp32)
SCORE_ELEMENTS = 1 << 28


def attention(q, k, v, quant):
    """Causal GQA attention over q (B, H, S, hd), k and v (B, KV, S, hd), a
    block of whole sequences at a time. Returns (B, S, H * hd)."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    rows = max(1, SCORE_ELEMENTS // (h * s * s))
    outs = []
    for i in range(0, b, rows):
        scores = mm(q[i:i + rows] * hd ** -0.5, k[i:i + rows].transpose(-1, -2), quant)
        p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(mm(p, v[i:i + rows], quant))
    return torch.cat(outs).transpose(1, 2).reshape(b, s, h * hd)


def capacity(t: int, k: int, e: int, factor: float) -> int:
    c = math.ceil(t * k / e * factor)
    return max(min(max(c, 4), t * k), 1)


def swiglu(x, gate, up, down, quant):
    return mm(F.silu(mm(x, gate, quant)) * mm(x, up, quant), down, quant)


def moe(x, router, gate, up, down, cfg, quant):
    """x (T, d) -> (y (T, d), load-balance loss)."""
    t, d = x.shape
    n_exp, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(x, router, quant), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    top = F.one_hot(idx[:, 0], n_exp).float()
    aux = n_exp * torch.mean(top.mean(dim=0) * probs.mean(dim=0))
    cap = capacity(t, k, n_exp, cfg["capacity_factor"])
    flat = idx.reshape(-1)
    rows, outs = [], []
    for e in range(n_exp):
        kept = torch.nonzero(flat == e)[:cap, 0]  # ascending: the flat order
        if kept.numel():
            rows.append(kept)
            outs.append(swiglu(x[kept // k], gate[e], up[e], down[e], quant))
    routed = torch.zeros(t * k, d, dtype=x.dtype, device=x.device)
    if rows:
        routed = routed.index_copy(0, torch.cat(rows), torch.cat(outs))
    return (routed.view(t, k, d) * w[..., None]).sum(dim=1), aux


def block(x, cfg, quant, attn_norm, wq, wk, wv, wo, ffn_norm, *ffn):
    w = dims(cfg)
    b, s, _ = x.shape
    eps = cfg["rms_norm_eps"]
    hx = rmsnorm(x, attn_norm, eps)

    def heads(t, n):
        return t.view(b, s, n, w["hd"]).transpose(1, 2)

    q = rope(heads(mm(hx, wq, quant), w["h"]), cfg["rope_theta"])
    k = rope(heads(mm(hx, wk, quant), w["kv"]), cfg["rope_theta"])
    v = heads(mm(hx, wv, quant), w["kv"])
    x = x + mm(attention(q, k, v, quant), wo, quant)
    hx = rmsnorm(x, ffn_norm, eps)
    if w["experts"]:
        y, aux = moe(hx.reshape(b * s, -1), *ffn, cfg, quant)
        return x + y.view(b, s, -1), aux
    return x + swiglu(hx, *ffn, quant), torch.zeros((), device=x.device)


def loss_fn(params: dict, tokens, labels, cfg: dict, quant=False, remat=True):
    """(loss, {"ce", "aux"}) of a batch of tokens (B, S) and labels (B, S).
    ``remat`` runs each block again in the backward (its activations are not
    kept), so that a full-width step fits beside its optimizer state."""
    w = dims(cfg)
    ffn_kinds = ("router", "e_gate", "e_up", "e_down") if w["experts"] else (
        "w_gate", "w_up", "w_down")
    per_layer = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm") + ffn_kinds
    x = F.embedding(tokens, params["embed"])
    aux = torch.zeros((), device=x.device)
    for i in range(w["layers"]):
        args = [params[kind][i] for kind in per_layer]
        if remat:
            x, a = checkpoint(block, x, cfg, quant, *args, use_reentrant=False)
        else:
            x, a = block(x, cfg, quant, *args)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg["rms_norm_eps"])
    logits = mm(x, params["embed"].t(), quant)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(lse - gold + cfg["z_loss"] * torch.square(lse))
    return ce + cfg["router_aux_loss_coef"] * aux, {"ce": ce, "aux": aux}


# -------------------------------------------------------------------------
# AdamW and the readings
# -------------------------------------------------------------------------

def schedule(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


def decays(cfg: dict, opt: dict, kind: str) -> bool:
    if kind == "final_norm":
        return bool(opt.get("decay_vectors", False))
    if kind in ("attn_norm", "ffn_norm"):
        return bool(cfg["layer_norm_scales_decay"])
    return True


def kind_norms(pairs) -> dict:
    """{kind: the norm of all its leaves together} of [(kind, tensor)]."""
    sq = {}
    for kind, t in pairs:
        sq[kind] = sq.get(kind, 0.0) + float(torch.sum(torch.square(t.detach().double())))
    return {kind: math.sqrt(v) for kind, v in sq.items()}


def train(params: dict, batches: list, cfg: dict, opt: dict, seed: int, *, quant=False,
          remat=True) -> dict:
    """Runs one AdamW step a batch from the seeded ``params`` (updated in
    place) and returns the readings the benchmark compares: each step's
    loss, the first step's global gradient norm before clipping, each
    kind's norm of the first gradient as the optimizer takes it (clipped)
    and that gradient's elements at the kind's sampled indices, and each
    kind's norm of the change of its weights over all the steps."""
    flat = leaves(params)
    m = [torch.zeros_like(t) for _, t in flat]
    v = [torch.zeros_like(t) for _, t in flat]
    losses, first = [], {}
    device = flat[0][1].device
    for step, batch in enumerate(batches):
        tokens = torch.as_tensor(batch["tokens"], device=device).long()
        labels = torch.as_tensor(batch["labels"], device=device).long()
        loss, _ = loss_fn(params, tokens, labels, cfg, quant=quant, remat=remat)
        grads = torch.autograd.grad(loss, [t for _, t in flat])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(torch.sum(torch.square(g.double()))) for g in grads))
            scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
            if step == 0:
                first = {"grad_norm": gnorm,
                         "grad": kind_norms((kind, g * scale) for (kind, _), g in zip(flat, grads)),
                         "grad_sample": {
                             kind: gather([g * scale for (k, _), g in zip(flat, grads) if k == kind],
                                          sample_index(cfg, kind, seed, device)).cpu()
                             for kind in params}}
            lr = schedule(opt, step)
            bc1 = 1 - opt["beta1"] ** (step + 1)
            bc2 = 1 - opt["beta2"] ** (step + 1)
            for (kind, w), g, mi, vi in zip(flat, grads, m, v):
                g = g * scale
                mi.mul_(opt["beta1"]).add_((1 - opt["beta1"]) * g)
                vi.mul_(opt["beta2"]).add_((1 - opt["beta2"]) * torch.square(g))
                upd = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"])
                if decays(cfg, opt, kind):
                    upd = upd + opt["weight_decay"] * w
                w.sub_(lr * upd)
        del grads
    with torch.no_grad():
        delta = {}
        for kind in params:
            w0 = draw(cfg, kind, seed, device).float().view(ref_shape(cfg, kind))
            now = params[kind] if layered(cfg, kind) else [params[kind]]
            starts = w0.unbind(0) if layered(cfg, kind) else [w0]
            delta[kind] = math.sqrt(sum(float(torch.sum(torch.square((a - b).double())))
                                        for a, b in zip(now, starts)))
            del w0, starts
    return {"loss": losses, **first, "delta": delta}
