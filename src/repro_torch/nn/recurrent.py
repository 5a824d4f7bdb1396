"""Recurrent sequence mixers: the RG-LRU of RecurrentGemma/Griffin, with
its causal depthwise conv and block-diagonal gate projections, and xLSTM's
mLSTM and sLSTM.

The parallel RG-LRU calls ``kernels.ops.rglru_scan``: the Hopper scan
kernel for a CUDA tensor, its plain version for a CPU one. This is where
the reference runs ``jax.lax.associative_scan`` (its Pallas scan is reached
only from its kernel tests). In training (grad on) the kernel's outputs
carry ``RGLRUScanFn``, whose backward is the port's reverse-scan kernel;
the reference differentiates its associative scan. Decode takes one O(1)
step and stays plain PyTorch.

The mLSTM (a stabilized gated linear attention with a matrix memory) runs
chunkwise: quadratic inside a chunk, a carried (C, n, m) state across
chunks, one O(1) step in decode, and ``mlstm_ref`` as the stepwise oracle.
The sLSTM is a nonlinear recurrence through block-diagonal recurrent
weights, one step a token. The reference writes both as ``lax.scan``s over
jnp code and reaches no Pallas kernel from them, so here they are plain
PyTorch: Python loops over chunks and over time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels import cost, ops
from repro_torch.nn import params as prm
from repro_torch.parallel.sharding import (
    batch_heads_placements,
    contiguous_stride,
    heads_whole,
    pin_grad,
    placed_as,
)


# --------------------------------------------------------------------------
# Causal depthwise conv1d (width w)
# --------------------------------------------------------------------------

def def_causal_conv(width, channels):
    return {
        "w": prm.ParamDef((width, channels), ("conv", "lru"), init="scaled_fan_in"),
        "b": prm.bias(channels, "lru"),
    }


def _shift(x, j):
    """x (B, S, C) shifted j steps later along S, zeros before its start: a
    concatenation, not a pad and a slice, which on a DTensor give a wrong
    local shape in some PyTorch versions (2.11)."""
    b, s, c = x.shape
    if j == 0:
        return x
    zeros = torch.zeros((b, min(j, s), c), dtype=x.dtype, device=x.device)
    return zeros if j >= s else torch.cat([zeros, x[:, :s - j]], dim=1)


def causal_conv(p, x):
    """x: (B, S, C) → same shape; causal depthwise conv, width = p.w.shape[0].
    Accumulated in fp32 (tap j sees x shifted j steps back), bias in fp32."""
    width = p["w"].shape[0]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(width):
        out = out + _shift(x, j).float() * p["w"][width - 1 - j].float()
    out = out + p["b"].float()
    return out.to(x.dtype)


def causal_conv_step(p, x_t, state):
    """x_t: (B, C); state: (B, width-1, C) past inputs. Returns (y_t, state')."""
    window = torch.cat([state, x_t[:, None]], dim=1)  # (B, width, C)
    y = torch.einsum("bwc,wc->bc", window.float(), p["w"].float()) + p["b"].float()
    return y.to(x_t.dtype), window[:, 1:]


def conv_state_init(batch, width, channels, dtype, device="cpu"):
    return torch.zeros((batch, width - 1, channels), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Block-diagonal linear (Griffin's gate projections; xLSTM's recurrent R)
# --------------------------------------------------------------------------

def def_blockdiag(n_blocks, block_w, n_out_per_block=None):
    out_w = n_out_per_block or block_w
    return {
        "w": prm.ParamDef((n_blocks, block_w, out_w), ("heads", "lru", None),
                          init="scaled_fan_in"),
        "b": prm.ParamDef((n_blocks, out_w), ("heads", None), init="zeros"),
    }


def blockdiag(p, x):
    """x: (..., n_blocks, block_w) → (..., n_blocks, out_w), computed in fp32
    and rounded to x's dtype, as the reference does."""
    y = torch.einsum("...nb,nbo->...no", x.float(), p["w"].float())
    return (y + p["b"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

_RG_C = 8.0  # Griffin's fixed exponent scale
_LAMBDA_SHIFT = -5.0  # softplus(raw - 5) ≈ 0.0067 → a ≈ 0.95 at r=1


def def_rglru(width, n_heads):
    block_w = width // n_heads
    return {
        "a_gate": def_blockdiag(n_heads, block_w),
        "i_gate": def_blockdiag(n_heads, block_w),
        "lam": prm.ParamDef((width,), ("lru",), init="zeros", dtype="float32"),
    }


def _rglru_coeffs(p, x, n_heads):
    """x: (B, S, W) → log_a (B,S,W) fp32, gated input b (B,S,W) fp32. On a
    mesh whose split of W does not keep the heads whole (10 heads on a
    16-way ``lru``), W is gathered for the per-head gates and the
    coefficients split again as x was (``heads_whole``)."""
    b_, s, w = x.shape
    xw = heads_whole(x, 2, n_heads)
    # its gradient made whole as xw is before the reshape's backward merges
    # the heads again (torch 2.11 cannot merge them split on their width)
    xh = pin_grad(xw.reshape(b_, s, n_heads, w // n_heads))
    r = pin_grad(torch.sigmoid(blockdiag(p["a_gate"], xh).float()).reshape(b_, s, w))
    i = pin_grad(torch.sigmoid(blockdiag(p["i_gate"], xh).float()).reshape(b_, s, w))
    log_a = -_RG_C * F.softplus(p["lam"] + _LAMBDA_SHIFT) * r
    gated_x = i * xw.float()
    # sqrt(1 - a^2) input normalizer (Griffin eq. 4), computed from log_a.
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return placed_as(log_a, x), placed_as(multiplier * gated_x, x)


def rglru(p, x, n_heads, h0=None, force=None):
    """Parallel RG-LRU over a sequence. x: (B,S,W) → (y (B,S,W) in x's dtype,
    h_last (B,W) fp32). ``force`` goes to ``kernels.ops.rglru_scan``. Under
    grad it differentiates through the scan: its plain version's autograd
    on the CPU, ``RGLRUScanFn`` on the card (a and b are fp32 here, as the
    backward kernel takes them)."""
    log_a, b = _rglru_coeffs(p, x, n_heads)
    h0 = None if h0 is None else h0.float().contiguous()
    h, h_last = ops.rglru_scan(torch.exp(log_a), b, h0, force=force)
    return h.to(x.dtype), h_last


def rglru_step(p, x_t, h, n_heads):
    """One decode step. x_t: (B, W); h: (B, W) fp32 state."""
    log_a, b = _rglru_coeffs(p, x_t[:, None], n_heads)
    h_new = torch.exp(log_a[:, 0]) * h + b[:, 0]
    return h_new.to(x_t.dtype), h_new


def rglru_ref(p, x, n_heads, h0=None):
    """Step-by-step oracle."""
    log_a, b = _rglru_coeffs(p, x, n_heads)
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    hs = []
    for t in range(x.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)


# --------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory), chunkwise parallel
# --------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dk, dv) stabilized matrix memory C_hat, fp32
    n: torch.Tensor  # (B, H, dk)    stabilized normalizer n_hat, fp32
    m: torch.Tensor  # (B, H)        log stabilizer, fp32


def mlstm_state_init(batch, n_heads, dk, dv, device="cpu"):
    return MLSTMState(
        c=torch.zeros((batch, n_heads, dk, dv), dtype=torch.float32, device=device),
        n=torch.zeros((batch, n_heads, dk), dtype=torch.float32, device=device),
        m=torch.full((batch, n_heads), -1e30, dtype=torch.float32, device=device),
    )


def _prefix_sum(x):
    """Inclusive prefix sum over the last axis (fp32), as a masked sum of a
    (..., L, L) product. ``torch.cumsum`` of a float CUDA tensor has no
    deterministic kernel (``torch.use_deterministic_algorithms`` raises on
    it, and training on the card runs under it); a reduction over a fixed
    axis is deterministic, and exact products with 0 and 1 keep it an fp32
    sum with no TF32 setting involved."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    upto = (idx[:, None] >= idx[None, :]).to(x.dtype)  # [j, t]: t <= j
    return (x[..., None, :] * upto).sum(-1)


def mlstm_chunkwise(q, k, v, i_gate, f_gate, state=None, chunk=256):
    """Chunkwise-parallel stabilized mLSTM.

    q, k: (B, H, S, dk); v: (B, H, S, dv); i_gate/f_gate: (B, H, S) raw
    (pre-activation) gates; f goes through log-sigmoid, i through exp with
    the shared stabilizer m. The chunk is L = min(chunk, S) and must divide
    S, as the reference asserts. q is scaled by dk^-0.5 in its own dtype
    (in bf16 both the scale and the product round, as the reference's do),
    then every product runs in fp32. Returns (h (B, H, S, dv) in q's dtype,
    final MLSTMState)."""
    if isinstance(q, DTensor):
        return _mlstm_local(mlstm_chunkwise, q, k, v, i_gate, f_gate, state, chunk)
    b, hn, s, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = mlstm_state_init(b, hn, dk, dv, q.device)
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"mlstm_chunkwise: sequence length {s} is not a multiple of the "
                         f"chunk {L} (the reference asserts s % chunk == 0)")
    scale = dk ** -0.5
    logf = F.logsigmoid(f_gate.float())  # (B, H, S)
    logi = i_gate.float()
    # q * scale in q's dtype, the scale rounded to it first: the reference
    # multiplies by a weak-typed Python float, which JAX casts to q's dtype
    # (a CPU scalar tensor: no host-to-device copy)
    qs = q * torch.tensor(scale, dtype=q.dtype)
    # split once, so that under grad each input's gradient is one cat
    chunks = zip(*(x.split(L, dim=2) for x in (qs, k, v, logf, logi)))
    idx = torch.arange(L, device=q.device)
    tri = idx[:, None] >= idx[None, :]  # (L, L) causal within a chunk
    c0, n0, m0 = state
    hs = []
    for qi, ki, vi, lfi, lii in chunks:
        qi, ki, vi = qi.float(), ki.float(), vi.float()
        bcum = _prefix_sum(lfi)  # (B, H, L) inclusive log product of f
        btot = bcum[..., -1]
        # log weight of intra source t for target l: bcum_l - bcum_t + li_t
        g_src = lii - bcum
        intra_log = bcum[..., :, None] + g_src[..., None, :]  # (B, H, L, L)
        intra_log = torch.where(tri, intra_log, -torch.inf)
        m_intra = torch.amax(intra_log, dim=-1)  # ties split the gradient, as jnp.max
        m_inter = bcum + m0[..., None]
        m_j = torch.maximum(m_inter, m_intra)
        d_mat = torch.exp(intra_log - m_j[..., None])
        s_qk = torch.einsum("bhld,bhtd->bhlt", qi, ki) * d_mat
        num_intra = torch.einsum("bhlt,bhtv->bhlv", s_qk, vi)
        den_intra = torch.sum(s_qk, dim=-1)
        w_inter = torch.exp(m_inter - m_j)
        num_inter = torch.einsum("bhld,bhdv->bhlv", qi, c0)
        den_inter = torch.einsum("bhld,bhd->bhl", qi, n0)
        num = num_inter * w_inter[..., None] + num_intra
        den = den_inter * w_inter + den_intra
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_j))[..., None])
        # the state at the chunk's end
        m_new = torch.maximum(btot + m0, torch.amax(lii + (btot[..., None] - bcum), dim=-1))
        w_old = torch.exp(btot + m0 - m_new)
        w_src = torch.exp(lii + btot[..., None] - bcum - m_new[..., None])
        kw = ki * w_src[..., None]
        c0 = c0 * w_old[..., None, None] + torch.einsum("bhld,bhlv->bhdv", kw, vi)
        n0 = n0 * w_old[..., None] + torch.sum(kw, dim=2)
        m0 = m_new
    return torch.cat(hs, dim=2).to(q.dtype), MLSTMState(c0, n0, m0)


def mlstm_step(q, k, v, i_gate, f_gate, state: MLSTMState):
    """One decode step. q, k: (B, H, dk); v: (B, H, dv); gates (B, H). q is
    scaled in fp32 (the reference's step, unlike its chunkwise form).
    DTensors run on local shards (``_mlstm_local``)."""
    if isinstance(q, DTensor):
        return _mlstm_local(mlstm_step, q, k, v, i_gate, f_gate, state)
    scale = q.shape[-1] ** -0.5
    logf = F.logsigmoid(f_gate.float())
    logi = i_gate.float()
    m_new = torch.maximum(logf + state.m, logi)
    w_old = torch.exp(logf + state.m - m_new)
    w_in = torch.exp(logi - m_new)
    kf = k.float() * w_in[..., None]
    c = state.c * w_old[..., None, None] + kf[..., :, None] * v.float()[..., None, :]
    n = state.n * w_old[..., None] + kf
    qf = q.float() * scale
    num = torch.einsum("bhd,bhdv->bhv", qf, c)
    den = torch.einsum("bhd,bhd->bh", qf, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), MLSTMState(c, n, m_new)


def mlstm_ref(q, k, v, i_gate, f_gate, state=None):
    """Step-by-step oracle of ``mlstm_chunkwise`` (``mlstm_step`` over time):
    (h (B, H, S, dv) in q's dtype, final MLSTMState)."""
    b, hn, _, dk = q.shape
    st = state if state is not None else mlstm_state_init(b, hn, dk, v.shape[-1], q.device)
    hs = []
    for xs in zip(*(x.unbind(2) for x in (q, k, v, i_gate, f_gate))):
        h, st = mlstm_step(*xs, st)
        hs.append(h)
    return torch.stack(hs, dim=2), st


# --------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory with recurrence), sequential
# --------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh) fp32
    n: torch.Tensor  # (B, H, dh) fp32
    m: torch.Tensor  # (B, H, dh) fp32
    h: torch.Tensor  # (B, H, dh) fp32, fed back through R


def slstm_state_init(batch, n_heads, dh, device="cpu"):
    def z():
        return torch.zeros((batch, n_heads, dh), dtype=torch.float32, device=device)

    return SLSTMState(z(), z(), torch.full((batch, n_heads, dh), -1e30, device=device), z())


_GATES = ("i", "f", "z", "o")


def def_slstm_core(n_heads, dh):
    # Recurrent block-diagonal weights of the four gates (i, f, z, o).
    return {f"r{g}": prm.ParamDef((n_heads, dh, dh), ("heads", None, None),
                                  init="scaled_fan_in", scale=0.3)
            for g in _GATES}


_N_FLOOR = torch.tensor(1e-6)  # a CPU scalar: no host-to-device copy a step


def _slstm_cell(x_t, r, state: SLSTMState):
    """One step from the four gates' input pre-activations side by side,
    x_t (B, H, 4·dh) fp32, and their recurrent weights side by side, r (H,
    dh, 4·dh): one product for the four gates (each output element the same
    dot product the reference's per-gate einsum takes). r is cast to fp32
    here, in each step, as the reference casts it (so a bf16 weight's
    gradient is summed over the steps in bf16, as the reference's is)."""
    hf = state.h
    g = x_t + torch.einsum("bhd,hde->bhe", hf, r.float())
    gi, gf, gz, go = g.chunk(4, dim=-1)
    logf = F.logsigmoid(gf)
    logf_m = logf + state.m
    m_new = torch.maximum(logf_m, gi)
    i_p = torch.exp(gi - m_new)
    f_p = torch.exp(logf_m - m_new)
    c = f_p * state.c + i_p * torch.tanh(gz)
    n = f_p * state.n + i_p
    # torch.maximum, not clamp: a tie splits the gradient, as jnp.maximum
    h = torch.sigmoid(go) * c / torch.maximum(n, _N_FLOOR)
    return h, SLSTMState(c, n, m_new, h)


def _side_by_side(p, x_gates):
    """(the recurrent weights (H, dh, 4·dh), the inputs (..., 4·dh) fp32),
    each in the gate order i, f, z, o."""
    r = torch.cat([p[f"r{g}"] for g in _GATES], dim=-1)
    return r, torch.cat([x_gates[g].float() for g in _GATES], dim=-1)


def slstm_step(p, x_gates, state: SLSTMState):
    """One step. x_gates: {"i", "f", "z", "o"} of (B, H, dh) pre-activations
    from the input; p: {"ri", "rf", "rz", "ro"} of (H, dh, dh). Returns (h
    fp32, new state). DTensors run on local shards (``_slstm_local``)."""
    if isinstance(x_gates["i"], DTensor):
        return _slstm_local(slstm_step, p, x_gates, state)
    r, x_t = _side_by_side(p, x_gates)
    return _slstm_cell(x_t, r, state)


def slstm_scan(p, x_gates, state=None):
    """x_gates: {"i", "f", "z", "o"} of (B, H, S, dh). ``slstm_step`` over
    time; returns (h (B, H, S, dh) in the gates' dtype, final state). The
    gates' inputs are cast and put side by side once, then unbound along
    time once (so that under grad their gradient is one ``stack``, not a
    zero-filled tensor a step); each step is one product and the cell's
    elementwise ops."""
    if isinstance(x_gates["i"], DTensor):
        return _slstm_local(slstm_scan, p, x_gates, state)
    b, hn, s, dh = x_gates["i"].shape
    st = state if state is not None else slstm_state_init(b, hn, dh, x_gates["i"].device)
    r, xs = _side_by_side(p, x_gates)
    if xs.is_meta:
        hs, *last = _SLSTMLoopMeta.apply(xs, r, *st)
        return hs.to(x_gates["i"].dtype), SLSTMState(*last)
    hs = []
    for x_t in xs.unbind(2):
        h, st = _slstm_cell(x_t, r, st)
        hs.append(h)
    return torch.stack(hs, dim=2).to(x_gates["i"].dtype), st


def _measure_step(x_t, r, state):
    """One ``_slstm_cell`` step on fresh meta leaves, counted by the active
    cost counter's ``measure`` (away from its own count): (the forward's
    count, the backward's count, the bytes of the storages the step saves
    for its backward, those of its long-lived inputs x and r left out), or
    None with no counter."""
    counter = cost.counter()
    if counter is None:
        return None
    with _disable_current_modes():
        leaves = [t.detach().requires_grad_() for t in (x_t, r, *state)]
    saved = []

    def forward():
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            h, st = _slstm_cell(leaves[0], leaves[1], SLSTMState(*leaves[2:]))
        return [h, *st]

    fwd, outs = counter.measure(forward)
    with _disable_current_modes():
        grads = [torch.empty_like(o) for o in outs]
    bwd, _ = counter.measure(lambda: torch.autograd.grad(outs, leaves, grads, allow_unused=True))
    inputs = {x_t.untyped_storage()._cdata, r.untyped_storage()._cdata}
    sizes = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in saved}
    return fwd, bwd, sum(n for key, n in sizes.items() if key not in inputs)


class _SLSTMLoopMeta(torch.autograd.Function):
    """The sLSTM's time loop on meta tensors (the dry-run's). Every step
    runs the same ops on the same shapes, so one step is run and counted
    (``_measure_step``: its forward, its backward and the bytes it saves
    for its backward) and the loop costs that step's count times the
    steps, where executing tens of thousands of steps of meta ops would
    take the host hours. What the loop allocates is allocated: the stacked
    h (B, H, S, dh) fp32 and the final state; under grad the steps' saved
    tensors (one buffer of their bytes, kept for the backward), else the S
    steps' h, held until their stack; in the backward the S steps' input
    gradients and their stack, r's and the initial state's gradients."""

    @staticmethod
    def forward(ctx, xs, r, c, n, m, h):
        b, hn, s, _ = xs.shape
        step = _measure_step(xs[:, :, 0], r, SLSTMState(c, n, m, h))
        hs_bytes = b * hn * s * c.shape[-1] * 4
        if step is not None:  # the steps, then the stack of their h (read, written)
            cost.report_loop("slstm_scan", s * step[0].flops, s * step[0].bytes + 2 * hs_bytes)
        grad = any(ctx.needs_input_grad)
        nbytes = s * (step[2] if step else 0) if grad else hs_bytes
        held = torch.empty((nbytes,), dtype=torch.uint8, device=xs.device)
        hs = torch.empty((b, hn, s, c.shape[-1]), dtype=torch.float32, device=xs.device)
        last = [torch.empty_like(t) for t in (c, n, m, h)]
        ctx.step, ctx.steps = step, s
        if grad:
            ctx.save_for_backward(held, xs, r, c)
        del held
        return (hs, *last)

    @staticmethod
    def backward(ctx, *_):
        _, xs, r, c = ctx.saved_tensors
        if ctx.step is not None:  # the steps, then the stack of their x gradients
            cost.report_loop("slstm_scan_bwd", ctx.steps * ctx.step[1].flops,
                             ctx.steps * ctx.step[1].bytes + 2 * xs.numel() * 4)
        per_step = torch.empty(xs.shape, dtype=torch.float32, device=xs.device)
        dxs = torch.empty(xs.shape, dtype=torch.float32, device=xs.device)
        del per_step
        return (dxs, torch.empty_like(r), *(torch.empty_like(c) for _ in range(4)))


def _bh_local(t, pl, grads=None):
    return t.redistribute(t.device_mesh, pl).to_local(grad_placements=grads)


def _bh_wrap(t, mesh, pl):
    """A local (B, H, ...) shard as a DTensor placed ``pl`` (even splits)."""
    shape = list(t.shape)
    for i, q in enumerate(pl):
        if isinstance(q, Shard):
            shape[q.dim] *= mesh.size(i)
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _mlstm_local(fn, q, k, v, i_gate, f_gate, state, *extra):
    """``fn`` (``mlstm_chunkwise`` or ``mlstm_step``) of DTensors on each
    rank's local shards of batch and heads (as ``_slstm_local``): each
    (batch row, head) is its own recurrence, DTensor has no strategy for
    some of its ops' backwards (``log_sigmoid_backward``), and its plans
    for a step's split heads take minutes on a 3-D mesh."""
    mesh, pl = q.device_mesh, batch_heads_placements(q)
    h, st = fn(*(_bh_local(t, pl) for t in (q, k, v, i_gate, f_gate)),
               None if state is None else MLSTMState(*(_bh_local(t, pl) for t in state)),
               *extra)
    return _bh_wrap(h, mesh, pl), MLSTMState(*(_bh_wrap(t, mesh, pl) for t in st))


def _slstm_local(fn, p, x_gates, state):
    """``fn`` (``slstm_scan`` or ``slstm_step``) of DTensors on each rank's
    local shards. The recurrence is independent for each (batch row, head),
    so the time loop runs on plain tensors: DTensor's dispatch at every op
    of every step would cost the host seconds a layer (32,768 steps in a
    32k prefill). The gates are placed first as the input gate's split of
    batch (dim 0) and heads (dim 1), every other split gathered and partial
    sums reduced; the recurrent weights' heads split as the gates' heads,
    else whole, and their gradient is then a partial sum over the axes that
    split the batch. The state is placed as the gates."""
    xi = x_gates["i"]
    mesh, pl = xi.device_mesh, batch_heads_placements(xi)
    r_pl = tuple(Shard(0) if q == Shard(1) else Replicate() for q in pl)
    grads = tuple(Partial() if q == Shard(0) else w for q, w in zip(pl, r_pl))
    h, st = fn({k: _bh_local(w, r_pl, grads) for k, w in p.items()},
               {g: _bh_local(t, pl) for g, t in x_gates.items()},
               None if state is None else SLSTMState(*(_bh_local(t, pl) for t in state)))
    return _bh_wrap(h, mesh, pl), SLSTMState(*(_bh_wrap(t, mesh, pl) for t in st))
