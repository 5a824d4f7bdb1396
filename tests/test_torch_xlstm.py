"""The port's xlstm-125m serving slice (the mLSTM and sLSTM of
repro_torch.nn.recurrent, their blocks, the tiny model and ServeEngine)
against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds. The JAX package materializes
the params and ``repro_torch.convert`` loads them, so both packages run
the same weights; xlstm has no attention block, so every projection of the
reference init is already at its true fan-in (ROADMAP C.9 rescales only
attention's), and the zero-init biases (the gate biases, the convs') are
redrawn nonzero so that their terms carry values. Tolerances: functions at
atol = rtol = 1e-5 in fp32 and 2e-2 in bf16, blocks at 1e-4 in fp32, the
model's prefill logits, states and final hidden state at 1e-4 in fp32, and
its bf16 logits at 5e-2. The reference calls are jitted.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_recurrent import _close, _jax_serve, _np_tree, _port_serve
from test_torch_recurrent_train import _rel_close
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.models import steps as jsteps
from repro.nn import blocks as jblocks
from repro.nn import layers as jlayers
from repro.nn import params as jprm
from repro.nn import recurrent as jrec
from repro.utils.trees import path_str

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import steps
from repro_torch.nn import blocks, layers, recurrent
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

ARCH = "xlstm-125m"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
FP32_KEEP = ("out_norm", "scale")  # leaves the models keep in fp32


def _rng(seed=0):
    return np.random.default_rng(seed)


def _to(arr, dtype):
    """numpy → (jax array, torch tensor) in ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    arr = np.array(arr, np.float32)
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _trees(flat, dtype):
    """{path: numpy} → (jax tree, torch tree) in ``dtype``; the output norms
    and norm scales stay fp32, as the models keep them."""
    jt, tt = {}, {}
    for p, a in flat.items():
        jt[p], tt[p] = _to(a, "float32" if p.rsplit("/", 1)[-1] in FP32_KEEP else dtype)
    return tree_unflatten(jt), tree_unflatten(tt)


def redraw_biases(flat, seed):
    """The zero-init leaves drawn nonzero from ``seed``: the gate biases
    N(0, 0.5), the conv biases N(0, 0.1), the output norms and norm scales
    1 + N(0, 0.1). Returns a new {path: fp32 numpy} dict."""
    rng = _rng(seed)
    out = {}
    for p, a in flat.items():
        a = np.asarray(a, np.float32)
        name = "/".join(p.split("/")[-2:])
        if p.rsplit("/", 1)[-1] in ("bi", "bf"):
            a = 0.5 * rng.standard_normal(a.shape)
        elif name == "conv/b":
            a = 0.1 * rng.standard_normal(a.shape)
        elif p.rsplit("/", 1)[-1] in FP32_KEEP:
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        out[p] = np.asarray(a, np.float32)
    return out


# --------------------------------------------------------------------------
# configs, def-tree, params
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tiny", [False, True])
def test_configs_equal_field_by_field(tiny):
    jcfg = jget_tiny(ARCH) if tiny else jget_config(ARCH)
    cfg = get_tiny_config(ARCH) if tiny else get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.pattern_for_layers() == jcfg.pattern_for_layers()


def _def_leaves(defs, is_def):
    return {path_str(p): d for p, d in
            jax.tree_util.tree_flatten_with_path(defs, is_leaf=is_def)[0]}


def test_full_width_def_tree_matches_jax():
    """12 layers alternating mlstm / slstm in the list layout: the
    reference's 176 leaf paths, shapes, inits, scales and dtypes. The
    leaves hold 134,351,664 params; ``param_count()``, an estimate, says
    129,521,664. ``out_norm`` is a bare fp32 leaf and the sLSTM's recurrent
    weights are (heads, dh, dh)."""
    jleaves = _def_leaves(jsteps.model_defs(jget_config(ARCH)),
                          lambda x: isinstance(x, jprm.ParamDef))
    want = {p: (tuple(d.shape), d.init, d.scale, d.dtype) for p, d in jleaves.items()}
    got = {p: (tuple(d.shape), d.init, d.scale, d.dtype)
           for p, d in tree_flatten_with_paths(steps.model_defs(get_config(ARCH)))}
    assert got == want and len(got) == 176
    assert got["blocks/layers/0/out_norm"] == ((1536,), "ones", None, "float32")
    assert got["blocks/layers/1/r/ri"] == ((4, 192, 192), "scaled_fan_in", 0.3, None)
    assert got["blocks/layers/1/ffn/up"][0] == (768, 1024)
    assert got["blocks/layers/0/wi"][0] == (1536, 4)
    assert sum(math.prod(s) for s, *_ in got.values()) == 134_351_664
    assert get_config(ARCH).param_count() == 129_521_664


def test_params_from_numpy_loads_reference_params():
    """The reference's 31 tiny leaves load by path, shape and dtype, bit for
    bit, and equal the port's own def-tree's."""
    jcfg, cfg = jget_tiny(ARCH), get_tiny_config(ARCH)
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(0)))
    params = params_from_numpy(flat, cfg, "cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_flatten_with_paths(params)}
    own = {p: (tuple(t.shape), t.dtype)
           for p, t in tree_flatten_with_paths(steps.init_params(cfg, seed=0))}
    assert got == own and set(got) == set(flat) and len(got) == 31
    assert got["blocks/layers/0/out_norm"] == ((128,), torch.float32)
    assert got["blocks/layers/1/r/rz"] == ((2, 32, 32), torch.bfloat16)
    assert np.array_equal(params["blocks"]["layers"][1]["r"]["ro"].view(torch.int16).numpy(),
                          flat["blocks/layers/1/r/ro"].view(np.int16))


# --------------------------------------------------------------------------
# the mLSTM
# --------------------------------------------------------------------------

B, H, S, DK, DV = 2, 2, 64, 48, 32


def _mlstm_np(seed=0, s=S):
    """q, k, v ~ N(0, 1); i-gates N(0, 0.5); f-gates N(3, 0.5), the model's
    +3.0 forget bias."""
    rng = _rng(seed)
    return (rng.standard_normal((B, H, s, DK)), rng.standard_normal((B, H, s, DK)),
            rng.standard_normal((B, H, s, DV)), 0.5 * rng.standard_normal((B, H, s)),
            3.0 + 0.5 * rng.standard_normal((B, H, s)))


def _mlstm_state_np(seed=1):
    """A state as a few chunks leave it: C, n of moderate size, m around 2."""
    rng = _rng(seed)
    return (rng.standard_normal((B, H, DK, DV)), rng.standard_normal((B, H, DK)),
            2.0 + rng.standard_normal((B, H)))


def _both(arrays, dtype):
    pairs = [_to(a, dtype) for a in arrays]
    return [j for j, _ in pairs], [t for _, t in pairs]


def _states(st_np):
    """fp32 (jax MLSTMState, torch MLSTMState) of numpy arrays."""
    if st_np is None:
        return None, None
    j, t = _both(st_np, "float32")
    return jrec.MLSTMState(*j), recurrent.MLSTMState(*t)


# The functions' and blocks' reference calls run eagerly: under jit, XLA on the CPU
# drops a bf16 rounding that is converted straight back to fp32 (excess
# precision), such as mlstm_chunkwise's q * scale, which the eager
# reference, like the port, rounds.


def _close_state(got, want, tol):
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, b, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [16, 32, S])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_jax(dtype, chunk, with_state):
    """h and the final (C, n, m) against the reference's chunkwise form, at
    chunks of 16 and 32 (4 and 2 chunks: the carried state between them)
    and the whole sequence, from no state and from a given one."""
    jx, tx = _both(_mlstm_np(), dtype)
    jst, st = _states(_mlstm_state_np() if with_state else None)
    h, fin = recurrent.mlstm_chunkwise(*tx, state=st, chunk=chunk)
    jh, jfin = jrec.mlstm_chunkwise(*jx, state=jst, chunk=chunk)
    tol = DTYPES[dtype][2]
    assert h.dtype == tx[0].dtype and h.shape == (B, H, S, DV)
    _close(h, jh, tol)
    _close_state(fin, jfin, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_step_matches_jax(dtype):
    jx, tx = _both([a[:, :, 0] for a in _mlstm_np(2)], dtype)
    jst, st = _states(_mlstm_state_np(3))
    h, new = recurrent.mlstm_step(*tx, st)
    jh, jnew = jrec.mlstm_step(*jx, jst)
    tol = DTYPES[dtype][2]
    assert h.dtype == tx[0].dtype
    _close(h, jh, tol)
    _close_state(new, jnew, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_ref_matches_jax(dtype):
    """The port's stepwise oracle against the reference's, from a state."""
    jx, tx = _both(_mlstm_np(4, s=24), dtype)
    jst, st = _states(_mlstm_state_np(5))
    h, fin = recurrent.mlstm_ref(*tx, st)
    jh, jfin = jrec.mlstm_ref(*jx, jst)
    tol = DTYPES[dtype][2]
    _close(h, jh, tol)
    _close_state(fin, jfin, tol)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunkwise_matches_the_ports_stepwise_oracle(chunk):
    """fp32: the chunkwise form against ``mlstm_ref`` in the port itself
    (the check chip_smoke.py runs on the card), within 1e-5."""
    _, tx = _both(_mlstm_np(6), "float32")
    h, fin = recurrent.mlstm_chunkwise(*tx, chunk=chunk)
    h_ref, fin_ref = recurrent.mlstm_ref(*tx)
    _close(h, h_ref.numpy(), 1e-5)
    for a, b in zip(fin, fin_ref):
        _close(a, b.numpy(), 1e-5)


def test_mlstm_chunkwise_refuses_a_chunk_that_does_not_divide():
    """The reference asserts s % L == 0; the port raises, naming the chunk."""
    _, tx = _both(_mlstm_np(7, s=47), "float32")
    with pytest.raises(ValueError, match="chunk 16"):
        recurrent.mlstm_chunkwise(*tx, chunk=16)
    with pytest.raises(AssertionError):
        jrec.mlstm_chunkwise(*_both(_mlstm_np(7, s=47), "float32")[0], chunk=16)


def test_prefix_sum_equals_cumsum():
    """The mLSTM's inclusive prefix sum of log-f (a masked sum, deterministic
    on CUDA where ``torch.cumsum`` of a float is not) within fp32 rounding
    of ``torch.cumsum``."""
    x = torch.from_numpy(-np.abs(_rng(8).standard_normal((3, 2, 64))).astype(np.float32))
    got = recurrent._prefix_sum(x)
    np.testing.assert_allclose(got.numpy(), torch.cumsum(x, -1).numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got[..., 0], x[..., 0])


class _Ops(TorchDispatchMode):
    """Records the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


# ops that raise under torch.use_deterministic_algorithms on a CUDA tensor
NONDETERMINISTIC = {torch.ops.aten.cumsum.default, torch.ops.aten.cumsum.out,
                    torch.ops.aten.put_.default, torch.ops.aten.histc.default,
                    torch.ops.aten.scatter_reduce.two, torch.ops.aten.median.dim}


def test_mlstm_and_slstm_run_no_cumsum_and_lower_their_products_to_bmm():
    """The chunkwise mLSTM's forward and backward (3 chunks) and the sLSTM's
    steps run no op that raises under deterministic algorithms on the card
    (``torch.cumsum`` among them); each chunk's five einsums and each
    sLSTM step's one recurrent product (the four gates' weights side by
    side) run as ``bmm``, the op the
    ``dots`` remat policy saves (``blocks._save_dots``), as
    ``dots_saveable`` saves the reference's dot_generals."""
    _, tx = _both(_mlstm_np(9, s=48), "float32")
    tx = [t.requires_grad_(True) for t in tx]
    with _Ops() as rec:
        h, _ = recurrent.mlstm_chunkwise(*tx, chunk=16)
        torch.autograd.grad(h.sum(), tx)
    fwd_bmm = [op for op in rec.ops if op in blocks._DOTS]
    assert not set(rec.ops) & NONDETERMINISTIC
    assert len(fwd_bmm) >= 15  # 5 products x 3 chunks forward, more backward
    with _Ops() as rec:
        recurrent.mlstm_chunkwise(*[t.detach() for t in tx], chunk=16)
    assert sum(op in blocks._DOTS for op in rec.ops) == 15

    rng = _rng(10)
    p = {g: torch.from_numpy(rng.standard_normal((2, 8, 8)).astype(np.float32))
         for g in ("ri", "rf", "rz", "ro")}
    gates = {g: torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(np.float32))
             for g in "ifzo"}
    with _Ops() as rec:
        recurrent.slstm_scan(p, gates)
    assert sum(op in blocks._DOTS for op in rec.ops) == 5
    assert not set(rec.ops) & NONDETERMINISTIC


# --------------------------------------------------------------------------
# the sLSTM
# --------------------------------------------------------------------------

def _slstm_np(seed, s=20, b=2, h=2, dh=16):
    rng = _rng(seed)
    r = {g: 0.3 * rng.standard_normal((h, dh, dh)) / math.sqrt(dh)
         for g in ("ri", "rf", "rz", "ro")}
    gates = {g: rng.standard_normal((b, h, s, dh)) for g in "ifzo"}
    gates["f"] = gates["f"] + 2.0
    st = (rng.standard_normal((b, h, dh)), 1.0 + rng.random((b, h, dh)),
          rng.standard_normal((b, h, dh)), rng.standard_normal((b, h, dh)))
    return r, gates, st


def _slstm_both(seed, dtype, with_state, s=20):
    r, gates, st = _slstm_np(seed, s)
    jr, tr = _trees(r, dtype)
    jg, tg = _trees(gates, dtype)
    if not with_state:
        return jr, tr, jg, tg, None, None
    j, t = _both(st, "float32")
    return jr, tr, jg, tg, jrec.SLSTMState(*j), recurrent.SLSTMState(*t)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_jax(dtype, with_state):
    """h (in the gates' dtype) and the final fp32 (c, n, m, h)."""
    jr, tr, jg, tg, jst, st = _slstm_both(11, dtype, with_state)
    h, fin = recurrent.slstm_scan(tr, tg, st)
    jh, jfin = jrec.slstm_scan(jr, jg, jst)
    tol = DTYPES[dtype][2]
    assert h.dtype == tg["i"].dtype and h.shape == (2, 2, 20, 16)
    _close(h, jh, tol)
    _close_state(fin, jfin, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slstm_step_matches_jax(dtype):
    jr, tr, jg, tg, jst, st = _slstm_both(12, dtype, True, s=1)
    h, new = recurrent.slstm_step(tr, {g: x[:, :, 0] for g, x in tg.items()}, st)
    jh, jnew = jrec.slstm_step(jr, {g: x[:, :, 0] for g, x in jg.items()}, jst)
    tol = DTYPES[dtype][2]
    assert h.dtype == torch.float32
    _close(h, jh, tol)
    _close_state(new, jnew, tol)


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

def block_flat(kind, seed):
    """The tiny config's ``kind`` block, reference-initialized, its biases,
    norms and output norm redrawn (``redraw_biases``)."""
    defs = {"mlstm": jblocks.def_mlstm_block, "slstm": jblocks.def_slstm_block}[kind]
    flat = _np_tree(jprm.materialize(jax.random.key(seed), defs(jget_tiny(ARCH)), jnp.float32))
    return redraw_biases(flat, seed)


def _block(kind, dtype, seed=13, **kw):
    jcfg = jget_tiny(ARCH).replace(dtype=dtype, **kw)
    cfg = get_tiny_config(ARCH).replace(dtype=dtype, **kw)
    jp, p = _trees(block_flat(kind, seed), dtype)
    return jcfg, cfg, jp, p


_APPLY = {"mlstm": (blocks.apply_mlstm_block, jblocks.apply_mlstm_block),
          "slstm": (blocks.apply_slstm_block, jblocks.apply_slstm_block)}
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _close_block(got, want, dtype):
    """fp32: within atol = rtol = 1e-4. bf16: within 2e-2 of the largest
    |want|, since the residual sums round at the scale of the whole
    stream (one bf16 ulp of a sum near 4 is 0.03)."""
    if dtype == "float32":
        _close(got, want, BLOCK_TOL[dtype])
    else:
        _rel_close(got.detach().float().numpy(), want, BLOCK_TOL[dtype])


def _state_pairs(st, jst):
    return [(st["conv"], jst["conv"])] + list(zip(st["state"], jst["state"]))


@pytest.mark.parametrize("dtype", list(BLOCK_TOL))
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_matches_jax(kind, dtype):
    """Each block's prefill at ``attn_chunk`` 16 over 48 tokens (3 mLSTM
    chunks): its x, its conv state (the last 3 pre-conv inputs) and its
    recurrent state."""
    jcfg, cfg, jp, p = _block(kind, dtype, attn_chunk=16)
    jx, x = _to(_rng(14).standard_normal((2, 48, 64)), dtype)
    port, ref = _APPLY[kind]
    y, st = port(p, x, cfg, mode="prefill")
    jy, jst, _ = ref(jp, jx, jcfg, mode="prefill")
    assert y.dtype == x.dtype and st["conv"].shape[1] == 3
    _close_block(y, jy, dtype)
    for got, want in _state_pairs(st, jst):
        assert tuple(got.shape) == tuple(want.shape)
        _close_block(got, want, dtype)


def _decode_state_np(kind, seed):
    """A decode state of the tiny block: conv history, and fp32 recurrent
    state as a prompt leaves it."""
    rng = _rng(seed)
    if kind == "mlstm":
        st = (rng.standard_normal((2, 2, 64, 64)), rng.standard_normal((2, 2, 64)),
              2.0 + rng.standard_normal((2, 2)))
        return rng.standard_normal((2, 3, 128)), st, jrec.MLSTMState, recurrent.MLSTMState
    st = (rng.standard_normal((2, 2, 32)), 1.0 + rng.random((2, 2, 32)),
          rng.standard_normal((2, 2, 32)), rng.standard_normal((2, 2, 32)))
    return rng.standard_normal((2, 3, 64)), st, jrec.SLSTMState, recurrent.SLSTMState


@pytest.mark.parametrize("dtype", list(BLOCK_TOL))
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_jax(kind, dtype):
    jcfg, cfg, jp, p = _block(kind, dtype)
    conv, st_np, jcls, tcls = _decode_state_np(kind, 15)
    jx, x = _to(_rng(16).standard_normal((2, 1, 64)), dtype)
    jconv, tconv = _to(conv, dtype)
    jst, st = _both(st_np, "float32")
    port, ref = _APPLY[kind]
    y, new = port(p, x, cfg, mode="decode", state={"conv": tconv, "state": tcls(*st)})
    jy, jnew, _ = ref(jp, jx, jcfg, mode="decode", state={"conv": jconv, "state": jcls(*jst)})
    assert y.dtype == x.dtype and isinstance(new["state"], tcls)
    _close_block(y, jy, dtype)
    for got, want in _state_pairs(new, jnew):
        _close_block(got, want, dtype)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_train_equals_prefill_output(kind):
    """Train mode computes what prefill computes from no state, and returns
    no state."""
    _, cfg, _, p = _block(kind, "float32")
    x = torch.from_numpy(_rng(17).standard_normal((2, 11, 64)).astype(np.float32))
    y_train, st = _APPLY[kind][0](p, x, cfg, mode="train")
    y_prefill, _ = _APPLY[kind][0](p, x, cfg, mode="prefill")
    assert st is None and torch.equal(y_train, y_prefill)
    with pytest.raises(ValueError, match="mode"):
        _APPLY[kind][0](p, x, cfg, mode="generate")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_of_short_prompt_pads_conv_state(kind):
    """A 2-token prompt (the reference cannot slice 3 inputs from it,
    ROADMAP C.7) leaves zeros before it in the conv state, as two decode
    steps from a zero state do; the recurrent states agree too."""
    _, cfg, _, p = _block(kind, "float32")
    x = torch.from_numpy(_rng(18).standard_normal((1, 2, 64)).astype(np.float32))
    y, st = _APPLY[kind][0](p, x, cfg, mode="prefill")
    state = blocks.init_block_state(cfg, kind, 1, 8, torch.float32)
    ys = []
    for t in range(2):
        yt, state = _APPLY[kind][0](p, x[:, t:t + 1], cfg, mode="decode", state=state)
        ys.append(yt)
    _close(st["conv"], state["conv"].numpy(), 1e-6)
    assert torch.equal(st["conv"][:, 0], torch.zeros_like(st["conv"][:, 0]))
    for a, b in zip(st["state"], state["state"]):
        _close(a, b.numpy(), 1e-5)
    _close(y, torch.cat(ys, dim=1).numpy(), 1e-5)


def test_group_rms_matches_jax():
    rng = _rng(19)
    jx, x = _to(rng.standard_normal((2, 5, 64)), "bfloat16")
    js, s = _to(1.0 + 0.1 * rng.standard_normal(64), "float32")
    y = blocks._group_rms(s, x, 4)
    assert y.dtype == torch.bfloat16
    _close(y, jblocks._group_rms(js, jx, 4), 2e-2)
    _, xf = _to(rng.standard_normal((2, 5, 64)), "float32")
    _close(blocks._group_rms(s, xf, 4), jblocks._group_rms(js, jnp.asarray(xf.numpy()), 4), 1e-6)


# --------------------------------------------------------------------------
# the tiny model end to end
# --------------------------------------------------------------------------

def model_params(jcfg, seed):
    """The reference's init of the tiny model, biases and norms redrawn
    (``redraw_biases``), each leaf in its own dtype: (jax params, {path:
    numpy})."""
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(seed)))
    redrawn = redraw_biases(flat, seed + 100)
    jparams = tree_unflatten({p: jnp.asarray(a).astype(flat[p].dtype)
                              for p, a in redrawn.items()})
    return jparams, _np_tree(jparams)


def _j_hidden(jcfg):
    def hidden(p, tokens):
        x = jlayers.embed_lookup(p["embed"], tokens).astype(jnp.dtype(jcfg.dtype))
        pos = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
        x, _, _ = jblocks.stack_apply(p["blocks"], x, jcfg, positions=pos, mode="prefill")
        return jlayers.norm(p["final_norm"], x, jcfg.rms_norm)

    return jax.jit(hidden)


def _port_hidden(cfg, params, tokens):
    x = layers.embed_lookup(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    pos = torch.arange(tokens.shape[1]).expand(tokens.shape)
    x, _ = blocks.stack_apply(params["blocks"], x, cfg, positions=pos, mode="prefill")
    return layers.rmsnorm(params["final_norm"], x)


def _assert_xlstm_states_close(states, jstates, kinds, tol):
    assert len(states) == len(jstates) == len(kinds)
    for kind, st, jst in zip(kinds, states, jstates):
        cls = recurrent.MLSTMState if kind == "mlstm" else recurrent.SLSTMState
        assert isinstance(st["state"], cls)
        for got, want in _state_pairs(st, jst):
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, tol)


@pytest.mark.parametrize("chunk", [512, 16])
def test_model_fp32_matches_jax(chunk):
    """fp32 tiny xlstm (mlstm, slstm), a 48-token prompt in one mLSTM chunk
    (attn_chunk 512) and in three (16): prefill logits, the final hidden
    state before the unembedding (the tiny logits are small, |logit| <
    1) and every block's conv and recurrent states within 1e-4; then 6
    greedy decode tokens identical to the reference serving loop's, and the
    decode states after them within 1e-4."""
    jcfg = jget_tiny(ARCH).replace(dtype="float32", attn_chunk=chunk)
    cfg = get_tiny_config(ARCH).replace(dtype="float32", attn_chunk=chunk)
    jparams, flat = model_params(jcfg, 0)
    params = params_from_numpy(flat, cfg, "cpu")
    prompts = _rng(20).integers(0, cfg.vocab_size, (2, 48))
    jlogits, jpf, jdec, jtoks = _jax_serve(jcfg, jparams, prompts, 6)
    logits, pf, dec, toks = _port_serve(cfg, params, prompts, 6)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
    hidden = _port_hidden(cfg, params, torch.from_numpy(prompts).long())
    jhidden = _j_hidden(jcfg)(jparams, jnp.asarray(prompts, jnp.int32))
    assert float(np.abs(np.asarray(jhidden)).max()) > 1.0
    _close(hidden, jhidden, 1e-4)
    kinds = cfg.pattern_for_layers()
    assert kinds == ("mlstm", "slstm")
    _assert_xlstm_states_close(pf, jpf, kinds, 1e-4)
    np.testing.assert_array_equal(toks, jtoks)
    _assert_xlstm_states_close(dec, jdec, kinds, 1e-4)


def test_model_bf16_prefill_logits_match_jax():
    """bf16 last logits within 5e-2 (the port's SwiGLU rounds the up and
    gate products to bf16 before the fp32 activation, ROADMAP C.8)."""
    jcfg, cfg = jget_tiny(ARCH).replace(attn_chunk=16), get_tiny_config(ARCH).replace(attn_chunk=16)
    jparams, flat = model_params(jcfg, 1)
    params = params_from_numpy(flat, cfg, "cpu")
    prompts = _rng(21).integers(0, cfg.vocab_size, (2, 32))
    _, _, jlast = jax.jit(jsteps.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
    _, _, last = steps.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(prompts).long()})
    assert last.dtype == torch.float32
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=5e-2, rtol=5e-2)


def test_prompt_not_a_multiple_of_the_chunk_raises_as_the_reference_asserts():
    """A prompt of 3 x attn_chunk - 1 tokens: the reference's mlstm_chunkwise
    asserts, the port raises ValueError naming the chunk; 3 x attn_chunk
    and any prompt of at most attn_chunk tokens prefill."""
    cfg = get_tiny_config(ARCH).replace(attn_chunk=16)
    jcfg = jget_tiny(ARCH).replace(attn_chunk=16)
    params = steps.init_params(cfg, seed=0)
    prefill = steps.make_prefill_step(cfg)
    with pytest.raises(ValueError, match="chunk 16"):
        prefill(params, {"tokens": torch.zeros((1, 47), dtype=torch.long)})
    with pytest.raises(AssertionError):
        jblocks.apply_mlstm_block(jsteps.init_params(jcfg, jax.random.key(0))["blocks"]
                                  ["layers"][0], jnp.zeros((1, 47, 64), jnp.bfloat16), jcfg,
                                  mode="prefill")
    for s in (48, 13):
        tok, _, last = prefill(params, {"tokens": torch.zeros((1, s), dtype=torch.long)})
        assert tok.shape == (1, 1) and bool(torch.isfinite(last).all())


def test_decode_state_is_per_kind():
    cfg = get_tiny_config(ARCH)
    states = steps.decode_state(cfg, 2, 50)
    assert states[0]["conv"].shape == (2, 3, 128) and states[0]["conv"].dtype == torch.bfloat16
    c, n, m = states[0]["state"]
    assert c.shape == (2, 2, 64, 64) and n.shape == (2, 2, 64) and m.shape == (2, 2)
    assert bool((m == -1e30).all()) and c.dtype == torch.float32
    assert states[1]["conv"].shape == (2, 3, 64)
    assert all(t.shape == (2, 2, 32) and t.dtype == torch.float32 for t in states[1]["state"])


# --------------------------------------------------------------------------
# ServeEngine and the serve CLI on tiny xlstm
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    return ServeEngine(ARCH, tiny=True, device="cpu")


def test_generate_shapes_and_is_deterministic(engine):
    prompts = engine.synthetic_prompts(2, 24)
    out = engine.generate(prompts, 4)
    assert out["tokens"].shape == (2, 4)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < engine.cfg.vocab_size)).all())
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    assert torch.equal(engine.generate(prompts, 4)["tokens"], out["tokens"])


def test_generate_runs_no_kernel(engine):
    """xlstm has no attention and no RG-LRU block: no kernel of the port
    runs on its path (on the card either)."""
    ops.reset_launch_counts()
    engine.generate(engine.synthetic_prompts(1, 8), 3)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "rglru_scan": 0, "rglru_scan_bwd": 0}


def test_infer_payload_knobs(engine):
    out = engine.infer({"prompt_len": 8, "gen": 4, "batch": 2})
    assert out["arch"] == ARCH and out["batch"] == 2 and out["prompt_len"] == 8
    assert len(out["tokens"]) == 4 and out["decode_ms_per_token"] > 0


def test_serve_cli_runs_tiny_xlstm(capsys):
    serve_cli.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--requests", "2",
                    "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=xlstm-tiny" in out and "decode:" in out
