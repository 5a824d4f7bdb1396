"""AdamW with fp32 master weights, global-norm clipping and the warmup +
cosine schedule: the reference's ``repro/optim/adamw.py``, rule for rule.

The optimizer state is the reference's layout (fp32 ``m``, ``v`` and master
copy per param leaf), so a checkpoint of either package restores in the
other. Scalars (the schedule, the bias corrections, the clip scale) are
fp32 tensors computed in the reference's order, not Python floats, which
are float64 and would differ in the last bits. The update is functional,
as the reference's is: it returns new tensors and leaves the old state as
it was. The train step donates the state instead (``donate=params``, as the
reference's train CLI donates its jitted step's): m, v, the master copy and
the params are then updated in place, with the same arithmetic and so the
same bits, and no second copy of the optimizer state is allocated
(recurrentgemma-2b's fp32 m, v and master take 32 GB).

On a mesh the leaves are DTensors: the params placed by their logical axes,
m, v and the master by ZeRO-1 (``parallel.zero``). The donated update then
runs the reference's ZeRO-1 schedule by hand: each gradient is
redistributed to its leaf's optimizer placement (a reduce-scatter over DP
of a partial sum), the global norm is taken over the DTensors, AdamW runs
on each rank's local shards of m, v and the master, in the same pieces,
and each new param is brought back to its own placement (an all-gather
over DP).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.nn.params import ShapeDtype
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # decay only matrices (dims >= 2), standard practice
    decay_vectors: bool = False


class OptState(NamedTuple):
    m: dict
    v: dict
    master: dict  # fp32 master copy of params


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, as an fp32 scalar tensor
    (on ``step``'s device when it is a tensor)."""
    device = step.device if isinstance(step, torch.Tensor) else None
    step = _f32(step, device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _map(fn, *trees):
    """``fn`` over the leaves of same-structured trees, by path."""
    flats = [dict(tree_flatten_with_paths(t)) for t in trees]
    return tree_unflatten({path: fn(*(f[path] for f in flats)) for path in flats[0]})


def init(params) -> OptState:
    """Zero ``m`` and ``v`` and an fp32 master copy (a new tensor even for
    fp32 params), on each param's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(m=_map(zeros, params), v=_map(zeros, params),
                    master=_map(lambda p: p.detach().to(torch.float32, copy=True), params))


def abstract_state(params) -> OptState:
    """The optimizer state's leaves as fp32 ``ShapeDtype`` (no allocation)
    for a tree of params or of their ``ShapeDtype``."""
    f32 = lambda p: ShapeDtype(tuple(p.shape), torch.float32)  # noqa: E731
    return OptState(m=_map(f32, params), v=_map(f32, params), master=_map(f32, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in fp32, the leaves summed in
    flattening order (sorted dict keys), as the reference sums them. Over
    DTensors each square sum is a partial sum over the shards, reduced
    once at the sqrt: a replicated 0-d DTensor."""
    total = None
    for _, leaf in tree_flatten_with_paths(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# The donated update's piece of a leaf, in elements (256 MiB of fp32)
DONATE_PIECE = 1 << 26


def _local(t):
    """A DTensor's local shard (its own storage, written in place), or t."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def update(cfg: AdamWConfig, grads, state: OptState, step, donate=None):
    """One AdamW step. ``grads`` in any dtype, the math in fp32 on the master
    weights; ``step`` the 0-d int step tensor before this update. With
    ``donate`` (the params tree that ``state`` belongs to) the update is
    written into ``state``'s tensors and ``donate``'s instead of new ones.
    DTensor leaves (module doc) take the donated update only.

    Returns (new_params (each cast to its grad's dtype, the param's own),
    new_state, {"grad_norm", "lr"})."""
    flat_m = dict(tree_flatten_with_paths(state.m))
    sharded = isinstance(next(iter(flat_m.values())), DTensor)
    if sharded:
        if donate is None:
            raise ValueError("adamw.update: DTensor state takes the donated update")
        # ZeRO-1: each gradient reduced straight to its optimizer placement
        grads = tree_unflatten({path: g.redistribute(flat_m[path].device_mesh,
                                                     flat_m[path].placements)
                                for path, g in tree_flatten_with_paths(grads)})
    gnorm = global_norm(grads)
    if isinstance(gnorm, DTensor):
        gnorm = gnorm.full_tensor()
    step = _local(step)
    device = gnorm.device
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = _f32(1.0, device)
    lr = schedule(cfg, step)
    t = _f32(step, device) + 1
    bc1 = 1.0 - torch.pow(_f32(cfg.beta1, device), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.beta2, device), t)

    def upd(g, m, v, w, decay):
        g = g.float() * scale
        if donate is None:
            m = cfg.beta1 * m + (1 - cfg.beta1) * g
            v = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g)
        else:  # the same products and sums, rounded alike, in place
            m.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
            v.mul_(cfg.beta2).add_((1 - cfg.beta2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        step_ = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay > 0:
            step_ = step_ + decay * w
        if donate is None:
            w = w - lr * step_
        else:
            w.sub_(lr * step_)
        return m, v, w

    flat_g = tree_flatten_with_paths(grads)
    flat_m, flat_v, flat_w = (dict(tree_flatten_with_paths(t))
                              for t in (state.m, state.v, state.master))

    def decay_of(w):  # the leaf as stored: a stacked (layers, d) norm scale decays
        return cfg.weight_decay if (w.dim() >= 2 or cfg.decay_vectors) else 0.0

    if donate is None:
        out = {path: upd(g, flat_m[path], flat_v[path], flat_w[path], decay_of(flat_w[path]))
               for path, g in flat_g}
        m = tree_unflatten({p: o[0] for p, o in out.items()})
        v = tree_unflatten({p: o[1] for p, o in out.items()})
        master = tree_unflatten({p: o[2] for p, o in out.items()})
        new_params = tree_unflatten({p: out[p][2].to(g.dtype) for p, g in flat_g})
        return new_params, OptState(m, v, master), {"grad_norm": gnorm, "lr": lr}
    flat_p = dict(tree_flatten_with_paths(donate))
    for path, g in flat_g:
        # A leaf at a time, in pieces of at most DONATE_PIECE elements, so
        # only one piece's fp32 temporaries live: a stacked expert leaf of
        # granite-moe (32 x 40 x 1536 x 512) takes 4 GiB a temporary. Each
        # op is elementwise, so the pieces give the whole leaf's bits.
        decay = decay_of(flat_w[path])
        p, w_full = flat_p[path], flat_w[path]
        gather = sharded and p.placements != w_full.placements
        # the param's own pieces, or (ZeRO-1) its shard in the master's placement
        p_loc = torch.empty_like(_local(w_full), dtype=p.dtype) if gather else _local(p)
        pieces = [_local(g).reshape(-1).split(DONATE_PIECE)] + [
            _local(t).view(-1).split(DONATE_PIECE)  # views: written in place
            for t in (flat_m[path], flat_v[path], w_full)] + [
            p_loc.view(-1).split(DONATE_PIECE)]
        for gp, mp, vp, wp, pp in zip(*pieces):
            _, _, w = upd(gp, mp, vp, wp, decay)
            pp.copy_(w)  # the master rounded to the param's dtype, as .to rounds
        if gather:  # the new param back to its own placement: all-gather over DP
            new = DTensor.from_local(p_loc, w_full.device_mesh, w_full.placements,
                                     run_check=False, shape=w_full.shape,
                                     stride=w_full.stride())
            _local(p).copy_(new.redistribute(p.device_mesh, p.placements).to_local())
    return donate, state, {"grad_norm": gnorm, "lr": lr}
