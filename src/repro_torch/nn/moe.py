"""Mixture-of-Experts FFN with top-k routing (granite-moe, qwen3-moe).

The reference's single-device path, ``moe_ffn_local``: a sort-based
dispatch of the (T·k) routed rows into per-expert capacity buffers, the
experts' SwiGLU as batched products over those buffers (the reference's
default ``impl="einsum"``; no caller takes its ``ragged_dot`` form), and a
combine of each token's k weighted expert outputs. Token dropping follows
GShard/Switch capacity semantics: per-expert capacity C = ceil(T·k / E ·
capacity_factor), floored at 4 and capped at T·k; rows past it are dropped
(weight 0). Which rows overflow depends on the stable sort's order over the
whole flattened stream, so a token's result depends on the rest of its
batch, as in the reference.

Three steps differ in form from the reference's, not in what they
compute: the dispatch map is built by a gather from the sorted order (the
reference scatters into it), the combine gathers each token's k slots and
sums them in k order in fp32 (the reference scatter-adds the slots in
expert order), and an empty slot or a dropped choice reads a row of its
own, weighted 0 (the reference's all read one row, which made the
gathers' backward under deterministic algorithms one long serial add).
All are free of atomics, so two calls give the same bits on the card too.

Under a mesh env ``moe_ffn`` takes the reference's two ``shard_map``
branches, on each rank's local shards (``to_local`` → ``moe_ffn_local`` →
``DTensor.from_local``); routing and capacity are then per local token set,
as in the reference:

* expert-parallel, where the ``model`` axis divides the experts: tokens
  split over DP and whole over ``model``, each model rank dispatching to its
  own ``e_local`` experts only; ``y`` is summed over ``model`` and ``aux``
  averaged over ``model``, then over DP;
* token-parallel, where it does not and divides the sequence: tokens split
  over DP and the sequence over ``model``, the experts whole on every rank;
  no collective but the ``aux`` mean.

(With neither, the experts are whole and every model rank computes the same
rows.) The combines are DTensor redistributions of partial sums, which carry
gradients: the params' and the input's gradients come back as the partial
sums over the ranks that shared them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.nn import params as prm
from repro_torch.nn.layers import activation
from repro_torch.parallel import current_env
from repro_torch.parallel.sharding import batch_only


def def_moe(d_model, n_experts, moe_d_ff, top_k, act="silu"):
    del top_k, act
    return {
        "router": prm.matrix(d_model, n_experts, "embed", "experts", dtype="float32"),
        "up": prm.ParamDef((n_experts, d_model, moe_d_ff),
                           ("experts", "embed", "expert_mlp"), init="scaled_fan_in"),
        "gate": prm.ParamDef((n_experts, d_model, moe_d_ff),
                             ("experts", "embed", "expert_mlp"), init="scaled_fan_in"),
        "down": prm.ParamDef((n_experts, moe_d_ff, d_model),
                             ("experts", "expert_mlp", "embed"), init="scaled_fan_in"),
    }


def capacity(t_local: int, top_k: int, n_experts: int, factor: float,
             min_capacity: int = 4) -> int:
    c = math.ceil(t_local * top_k / n_experts * factor)
    return max(min(max(c, min_capacity), t_local * top_k), 1)


def router_topk(p_router, x, top_k: int):
    """x: (T, d) → weights (T, k) fp32 (softmax over the selected k,
    renormalized), indices (T, k) int64, and the Switch-style load-balancing
    aux loss. The router's logits are an fp32 product, not TF32
    (``nn.policy``)."""
    logits = x.float() @ p_router
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, idx, load_balance_aux(probs, idx)


def load_balance_aux(probs, idx):
    """The Switch-style aux loss of router probabilities (T, E) and choices
    (T, k): n_experts * mean(frac_tokens_e * mean_prob_e), the fraction
    counting each token's top choice."""
    n_experts = probs.shape[-1]
    experts = torch.arange(n_experts, device=idx.device)
    hard = (idx[:, :1] == experts).float()  # one-hot of the top choice, no host sync
    return n_experts * torch.mean(hard.mean(dim=0) * probs.mean(dim=0))


def _dispatch_indices(idx, n_experts: int, cap: int, e_start: int = 0,
                      e_local: Optional[int] = None):
    """The gather map of the capacity buffers of experts [e_start, e_start +
    e_local) (all of them by default).

    idx: (T, k) expert assignment. Returns
      src:   (e_local * cap,) int64, the source row in the flattened (T·k)
             stream of each capacity slot (T·k marks an empty slot),
      sizes: (e_local,) int32, the valid rows of each local expert (<= cap).
    Slot c of expert e holds the c-th row routed to e in the stable sort of
    the flattened stream, if c < min(count_e, cap): the reference's map,
    read from the sorted order instead of scattered into."""
    t, k = idx.shape
    e_local = n_experts if e_local is None else e_local
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)  # rows grouped by expert
    # each expert's first row in the sorted stream and its row count (a
    # search of the sorted experts: bincount would wait on the host)
    experts = torch.arange(e_start, e_start + e_local + 1, device=idx.device)
    bounds = torch.searchsorted(flat[order], experts)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    sizes = torch.clamp(counts, max=cap)
    c = torch.arange(cap, device=idx.device)
    pos = starts[:, None] + c  # (n_experts, cap)
    valid = c < sizes[:, None]
    src = torch.where(valid, order[torch.clamp(pos, max=t * k - 1)], t * k)
    return src.reshape(-1), sizes.to(torch.int32)


def _expert_ffn(up, gate, down, rows, act="silu"):
    """The experts' SwiGLU over their capacity buffers: rows (E·C, d)
    grouped by expert → (E·C, d), batched products in rows' dtype with
    the activation and gating product in fp32 (the reference's einsum
    form)."""
    fn = activation(act)
    buf = rows.reshape(up.shape[0], -1, rows.shape[-1])  # (E, C, d)
    h_up = torch.bmm(buf, up)
    h_gate = torch.bmm(buf, gate)
    h = (fn(h_gate.float()) * h_up.float()).to(rows.dtype)
    return torch.bmm(h, down).reshape(rows.shape[0], -1)


def moe_ffn_local(p, x, *, top_k: int, capacity_factor: float = 1.25,
                  act: str = "silu", e_start: int = 0, e_local: Optional[int] = None):
    """MoE FFN on local rows for experts [e_start, e_start + e_local) (all of
    them by default; ``p``'s expert leaves hold those e_local experts).

    x: (T, d). Returns (y (T, d) in x's dtype, aux_loss () fp32); y sums
    the local experts' contributions only, the caller combines shards."""
    t, d = x.shape
    n_experts = p["router"].shape[-1]
    w, idx, aux = router_topk(p["router"], x, top_k)
    cap = capacity(t, top_k, n_experts, capacity_factor)
    src, _ = _dispatch_indices(idx, n_experts, cap, e_start, e_local)
    # Gather rows. An empty slot's output is never picked on combine, so the
    # row it reads does not matter: the reference's read the last token,
    # these read token (slot mod T), at most ceil(E·cap / T) of them a token.
    # The gather's backward accumulates each token's rows, and under
    # deterministic algorithms a token's rows are added one after another:
    # all empty slots on one token made that one add thousands long.
    n_rows, n_slots = t * top_k, src.shape[0]
    slots = torch.arange(n_slots, device=x.device)
    rows = x[torch.where(src < n_rows, src // top_k, slots % t)]  # (E*cap, d)
    out_rows = _expert_ffn(p["up"], p["gate"], p["down"], rows, act)
    # Combine: the slot of each (token, choice), or none where it was
    # dropped at capacity; a gather of its output, weighted. A dropped
    # choice reads slot (its row of the stream mod E·cap), weighted 0: its
    # own, for the same reason.
    slot_of = torch.full((n_rows + 1,), n_slots, dtype=src.dtype, device=x.device)
    slot_of[src] = slots  # empty slots write n_rows
    slot_of = slot_of[:n_rows].view(t, top_k)
    kept = slot_of < n_slots
    weight = torch.where(kept, w, 0.0)
    spread = torch.arange(n_rows, device=x.device).view(t, top_k) % n_slots
    picked = out_rows[torch.where(kept, slot_of, spread)].float()  # (T, k, d)
    y = picked[:, 0] * weight[:, 0, None]
    for j in range(1, top_k):
        y = y + picked[:, j] * weight[:, j, None]
    return y.to(x.dtype), aux


def moe_ffn(p, x, *, top_k: int, capacity_factor: float = 1.25, act: str = "silu"):
    """MoE FFN over x (B, S, d) → ((B, S, d), aux ()): with no mesh env,
    ``moe_ffn_local`` over all B·S tokens; under one, the reference's
    expert- or token-parallel branch (module doc) on DTensors."""
    env = current_env()
    if env.active:
        return moe_ffn_mesh(p, x, env, top_k=top_k, capacity_factor=capacity_factor,
                            act=act)
    b, s, d = x.shape
    y, aux = moe_ffn_local(p, x.reshape(-1, d), top_k=top_k,
                           capacity_factor=capacity_factor, act=act)
    return y.reshape(b, s, d), aux


def moe_branch(n_experts: int, seq: int, n_model: int) -> tuple[int, bool]:
    """(ep, token_parallel): the reference's pick of branch. ep is the
    expert-parallel degree, ``n_model`` where it divides the experts."""
    ep = n_model if n_experts % n_model == 0 else 1
    return ep, ep == 1 and seq % n_model == 0


def moe_ffn_mesh(p, x, env, *, top_k: int, capacity_factor: float = 1.25,
                 act: str = "silu"):
    """The reference's distributed ``moe_ffn`` on DTensors: x (B, S, d) and
    the MoE params on ``env``'s mesh → (y (B, S, d), aux () replicated)."""
    mesh = env.mesh
    names = mesh.mesh_dim_names
    dp_dims = [i for i, n in enumerate(names) if n in ("pod", "data")]
    m_dim = names.index("model") if "model" in names else None
    n_model = mesh.size(m_dim) if m_dim is not None else 1
    n_dp = math.prod(mesh.size(i) for i in dp_dims)
    b, s, d = x.shape
    n_experts = p["router"].shape[-1]
    ep, token_parallel = moe_branch(n_experts, s, n_model)
    e_local = n_experts // ep

    def pl(dp, model):
        out = [Replicate()] * mesh.ndim
        for i in dp_dims:
            out[i] = dp
        if m_dim is not None:
            out[m_dim] = model
        return tuple(out)

    def local(t, placements, grad):
        return t.redistribute(mesh, placements).to_local(grad_placements=grad)

    whole = pl(Replicate(), Replicate())
    if token_parallel:
        x_pl = pl(Shard(0), Shard(1))
        xl = local(x, x_pl, x_pl)
        pg = pl(Partial(), Partial())
        pl_loc = {k: local(v, whole, pg) for k, v in p.items()}
        e_start, e_local, combine, n_mean = 0, n_experts, x_pl, n_dp * n_model
    else:
        x_pl = pl(Shard(0), Replicate())
        xl = local(x, x_pl, pl(Shard(0), Partial() if ep > 1 else Replicate()))
        pl_loc = {"router": local(p["router"], whole,
                                  pl(Partial(), Partial() if ep > 1 else Replicate()))}
        e_pl = pl(Replicate(), Shard(0) if ep > 1 else Replicate())
        e_grad = pl(Partial(), Shard(0) if ep > 1 else Replicate())
        for k in ("up", "gate", "down"):
            pl_loc[k] = local(p[k], e_pl, e_grad)
        e_start = mesh.get_local_rank(m_dim) * e_local if ep > 1 else 0
        combine = pl(Shard(0), Partial() if ep > 1 else Replicate())
        n_mean = n_dp * (n_model if ep > 1 else 1)
    bl, sl, _ = xl.shape
    y, aux = moe_ffn_local(pl_loc, xl.reshape(-1, d), top_k=top_k,
                           capacity_factor=capacity_factor, act=act,
                           e_start=e_start, e_local=e_local)
    y = DTensor.from_local(y.reshape(bl, sl, d), mesh, combine, run_check=False)
    y = batch_only(y)  # the sum over model (expert-parallel), the gathered seq (token-)
    # the mean of the ranks' aux over DP and model (where they differ):
    # partial sums of aux / n, reduced
    aux_pl = pl(Partial(), Partial() if (token_parallel or ep > 1) else Replicate())
    aux = DTensor.from_local(aux / n_mean, mesh, aux_pl, run_check=False)
    return y, aux.redistribute(mesh, whole)
