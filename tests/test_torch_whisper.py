"""The port's whisper-tiny serving slice (the encoder-decoder, cross-attention,
LayerNorm, the ungated GELU MLP, sinusoidal positions) against the JAX
package, on the CPU, at the tiny config (enc_seq 32, attn_chunk 64).

The JAX package materializes the params. Then the LayerNorm scales and
biases (ones and zeros at init) are redrawn nonzero from a seeded numpy
generator, so a bias added in the wrong place shows, and the self- and
cross-attention projections are rescaled to their true fan-in (ROADMAP
C.9: the reference init divides by the heads axis). ``repro_torch.convert``
loads the same arrays. Frames and tokens are drawn with numpy from fixed
seeds. Tolerances: functions 1e-6 in fp32 and 2e-2 in bf16, the model
1e-4 in fp32 and 5e-2 in bf16, greedy tokens identical. In bf16 the
reference runs eagerly: jitted on the CPU, XLA drops bf16 roundings that
are converted straight back to fp32.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.models import encdec as jencdec
from repro.models import steps as jsteps
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import mlp as jmlp
from repro.nn import params as jprm
from repro.utils.trees import path_str
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import encdec, steps
from repro_torch.nn import attention, layers, mlp
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

ARCH = "whisper-tiny"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FN_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
N_DECODE = 6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np_tree(jtree):
    return {p: np.asarray(x) for p, x in jflatten(jtree)}


def _to(arr, dtype):
    """numpy → (jax array, torch tensor) in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    arr = np.array(arr, np.float32)
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(**kw):
    return jget_tiny(ARCH).replace(**kw), get_tiny_config(ARCH).replace(**kw)


def _fan_in_scale(jcfg):
    """{(block kind, leaf): factor} taking the reference init's attention
    projections to their true fan-in (d_model into q/k/v, heads x head_dim
    into the output)."""
    d, h, kv = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads
    return {("attn", "wq"): math.sqrt(h / d), ("attn", "wk"): math.sqrt(kv / d),
            ("attn", "wv"): math.sqrt(kv / d), ("attn", "wo"): math.sqrt(1 / h),
            ("cross", "wq"): math.sqrt(h / d), ("cross", "wk"): math.sqrt(h / d),
            ("cross", "wv"): math.sqrt(h / d), ("cross", "wo"): math.sqrt(1 / h)}


def model_params(jcfg, seed):
    """The reference's init of ``jcfg``, the norms redrawn (scale 1 +
    N(0, 0.1), bias N(0, 0.1)) and the attention projections at their true
    fan-in, each leaf in its own dtype: (jax params, {path: numpy})."""
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(seed)))
    rng, scale = _rng(seed + 100), _fan_in_scale(jcfg)
    out = {}
    for p, a in flat.items():
        parts = p.split("/")
        a32 = np.asarray(a, np.float32)
        if parts[-1] in ("scale", "bias"):
            a32 = (parts[-1] == "scale") + 0.1 * rng.standard_normal(a.shape)
        elif tuple(parts[-2:]) in scale:
            a32 = a32 * scale[tuple(parts[-2:])]
        out[p] = jnp.asarray(np.asarray(a32, np.float32)).astype(a.dtype)
    jparams = tree_unflatten(out)
    return jparams, _np_tree(jparams)


def _frames(cfg, b, seed, dtype):
    return _to(_rng(seed).standard_normal((b, cfg.enc_seq, cfg.d_model)), dtype)


# --------------------------------------------------------------------------
# configs, def-tree, params
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tiny", [False, True])
def test_configs_equal_field_by_field(tiny):
    jcfg = jget_tiny(ARCH) if tiny else jget_config(ARCH)
    cfg = get_tiny_config(ARCH) if tiny else get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    if not tiny:
        assert cfg.param_count() == 36_431_232


def _def_leaves(cfg_or_jcfg, port):
    if port:
        return {p: (tuple(d.shape), d.init, d.scale, d.dtype)
                for p, d in tree_flatten_with_paths(steps.model_defs(cfg_or_jcfg))}
    is_def = lambda x: isinstance(x, jprm.ParamDef)  # noqa: E731
    leaves = jax.tree_util.tree_flatten_with_path(jsteps.model_defs(cfg_or_jcfg),
                                                  is_leaf=is_def)[0]
    return {path_str(p): (tuple(d.shape), d.init, d.scale, d.dtype) for p, d in leaves}


def test_full_width_def_tree_matches_jax():
    """4 encoder and 4 decoder layers, tied embedding: the reference's leaf
    paths, shapes, inits, scales and dtypes, the LayerNorm biases fp32, no
    gate leaf in the GELU MLP; 36,448,128 elements with the norms."""
    got = _def_leaves(get_config(ARCH), True)
    assert got == _def_leaves(jget_config(ARCH), False)
    assert got["enc_norm/bias"] == ((384,), "zeros", None, "float32")
    assert got["dec/3/norm_cross/scale"] == ((384,), "ones", None, "float32")
    assert got["dec/0/cross/wk"] == ((384, 6, 64), "scaled_fan_in", None, None)
    assert got["enc/0/mlp/up"][0] == (384, 1536) and "enc/0/mlp/gate" not in got
    assert "unembed" not in got and got["embed"][0] == (51865, 384)
    assert sum(math.prod(s) for s, *_ in got.values()) == 36_448_128


@pytest.mark.parametrize("tiny", [False, True])
def test_params_from_numpy_loads_reference_params(tiny):
    """The reference's whisper params load by path, shape and dtype, bf16 bit
    for bit, the LayerNorm biases fp32, at both sizes."""
    jcfg = jget_tiny(ARCH) if tiny else jget_config(ARCH)
    cfg = get_tiny_config(ARCH) if tiny else get_config(ARCH)
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(1)))
    params = params_from_numpy(flat, cfg, "cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_flatten_with_paths(params)}
    assert set(got) == set(flat) == set(_def_leaves(cfg, True))
    assert got["enc/1/norm2/bias"][1] == torch.float32
    assert got["dec/1/cross/wv"] == ((cfg.d_model, cfg.n_heads, cfg.hd), torch.bfloat16)
    np.testing.assert_array_equal(params["dec"][0]["mlp"]["down"].view(torch.int16).numpy(),
                                  flat["dec/0/mlp/down"].view(np.int16))


def test_params_from_numpy_rejects_a_layernorm_bias_of_the_wrong_dtype():
    jcfg, cfg = _cfgs()
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(0)))
    bad = dict(flat, **{"enc_norm/bias": flat["enc_norm/bias"].astype(jnp.bfloat16)})
    with pytest.raises(ValueError, match="enc_norm/bias"):
        params_from_numpy(bad, cfg, "cpu")


# --------------------------------------------------------------------------
# LayerNorm, sinusoidal positions, the GELU MLP, cross-attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_matches_jax(dtype):
    """fp32 math, eps 1e-5, a nonzero scale and bias, back in x's dtype."""
    jx, x = _to(3.0 + 2.0 * _rng(1).standard_normal((2, 7, 64)), dtype)
    scale, bias = 1 + 0.3 * _rng(2).standard_normal(64), 0.5 * _rng(3).standard_normal(64)
    p = {"scale": torch.tensor(scale, dtype=torch.float32),
         "bias": torch.tensor(bias, dtype=torch.float32)}
    jp = {"scale": jnp.asarray(scale, jnp.float32), "bias": jnp.asarray(bias, jnp.float32)}
    got = layers.layernorm(p, x)
    assert got.dtype == x.dtype
    _close(got, jlayers.layernorm(jp, jx), FN_TOL[dtype])
    assert set(layers.def_layernorm(64)) == set(jlayers.def_layernorm(64)) == {"scale", "bias"}


def test_norm_dispatches_on_rms():
    x = torch.from_numpy(_rng(4).standard_normal((3, 32)).astype(np.float32))
    p = {"scale": torch.ones(32), "bias": torch.zeros(32)}
    assert torch.equal(layers.norm(p, x, rms=False), layers.layernorm(p, x))
    assert torch.equal(layers.norm(p, x, rms=True), layers.rmsnorm(p, x))
    assert set(layers.def_norm(32, False)) == {"scale", "bias"}
    assert set(layers.def_norm(32, True)) == {"scale"}


@pytest.mark.parametrize("seq,d,offset", [(32, 64, 0), (1500, 384, 0), (448, 384, 0),
                                          (1, 384, 447)])
def test_sinusoidal_positions_matches_jax(seq, d, offset):
    """fp32 within 1e-6 at the tiny and full encoder lengths, the decoder's
    448 and the decode step's single row at an offset."""
    got = layers.sinusoidal_positions(seq, d, offset=offset)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    _close(got, jlayers.sinusoidal_positions(seq, d, offset=offset), 1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_def_mlp_matches_jax(act):
    got = {p: (tuple(d.shape), d.init) for p, d in
           tree_flatten_with_paths(mlp.def_mlp(64, 128, act))}
    want = {p: (tuple(d.shape), d.init) for p, d in
            tree_flatten_with_paths(jmlp.def_mlp(64, 128, act))}
    assert got == want and ("gate" in got) == (act == "silu")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_mlp_matches_jax(dtype):
    """The ungated tanh-GELU MLP: fp32 within 1e-6; bf16 within 2e-2 (the
    port rounds up to bf16 before the fp32 activation, ROADMAP C.8)."""
    defs = jmlp.def_mlp(64, 128, "gelu")
    flat = _np_tree(jprm.materialize(jax.random.key(2), defs, jnp.float32))
    jp = tree_unflatten({p: _to(a, dtype)[0] for p, a in flat.items()})
    tp = tree_unflatten({p: _to(a, dtype)[1] for p, a in flat.items()})
    jx, x = _to(_rng(6).standard_normal((2, 9, 64)), dtype)
    got = mlp.mlp(tp, x, "gelu")
    assert got.dtype == x.dtype
    _close(got, jmlp.mlp(jp, jx, "gelu"), FN_TOL[dtype])


def _cross_inputs(dtype, seed=7, b=2, s=5, s_enc=32, d=64, h=4, hd=16):
    defs = jattn.def_cross_attention(d, h, hd)
    flat = _np_tree(jprm.materialize(jax.random.key(seed), defs, jnp.float32))
    flat = {p: a * (math.sqrt(h / d) if p != "wo" else math.sqrt(1 / h)) for p, a in flat.items()}
    jp = {p: _to(a, dtype)[0] for p, a in flat.items()}
    tp = {p: _to(a, dtype)[1] for p, a in flat.items()}
    jx, x = _to(_rng(seed + 1).standard_normal((b, s, d)), dtype)
    jm, m = _to(_rng(seed + 2).standard_normal((b, s_enc, d)), dtype)
    return jp, tp, jx, x, jm, m


@pytest.mark.parametrize("with_mem_kv", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_attention_matches_jax(dtype, with_mem_kv):
    """Naive bidirectional attention over the memory, or over its
    precomputed K/V: the output and the (k, v) it returns, fp32 within 1e-5
    and bf16 within 2e-2."""
    jp, tp, jx, x, jm, m = _cross_inputs(dtype)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    jy, (jk, jv) = jattn.cross_attention(jp, jx, memory=jm)
    y, (k, v) = attention.cross_attention(tp, x, memory=m)
    assert y.dtype == k.dtype == x.dtype and k.shape == (2, 4, 32, 16)
    _close(k, jk, tol)
    _close(v, jv, tol)
    _close(y, jy, tol)
    if with_mem_kv:
        jy2, _ = jattn.cross_attention(jp, jx, mem_kv=(jk, jv))
        y2, kv = attention.cross_attention(tp, x, mem_kv=(k, v))
        assert kv[0] is k and kv[1] is v
        _close(y2, jy2, tol)
        assert torch.equal(y2, y)


def test_cross_attention_bf16_memory_under_fp32_weights():
    """A bf16 memory against fp32 weights and fp32 queries: k and v are the
    fp32 products (JAX promotes the memory), not bf16-rounded ones."""
    jp, tp, jx, x, _, _ = _cross_inputs("float32")
    jm, m = _to(_rng(40).standard_normal((2, 32, 64)), "bfloat16")
    jy, (jk, _) = jattn.cross_attention(jp, jx, memory=jm)
    y, (k, _) = attention.cross_attention(tp, x, memory=m)
    assert k.dtype == y.dtype == torch.float32
    _close(k, jk, 1e-5)
    _close(y, jy, 1e-5)


def test_chunk_pick_matches_the_reference_twin():
    """The chunked oracle picks the reference twin's chunks (the largest
    divisor of the length at most the chunk: 500 at whisper's 1500), and at
    B1 H2 S1500 D16 bidirectional in fp32 it and the plain version are
    within 1e-6 of the reference twin."""
    for n, want in ((1500, 500), (448, 448), (32, 32), (1000, 500), (509, 509)):
        assert attention._pick_chunk(n, 512) == jattn._pick_chunk(n, 512) == want
    arrays = [_rng(s).standard_normal(shape) for s, shape in
              ((11, (1, 2, 1500, 16)), (12, (1, 2, 1500, 16)), (13, (1, 2, 1500, 16)))]
    jq, jk, jv = (_to(a, "float32")[0] for a in arrays)
    q, k, v = (_to(a, "float32")[1] for a in arrays)
    want = jattn.flash_attention(jq, jk, jv, causal=False, chunk=512)
    _close(attention.chunked_attention(q, k, v, causal=False, chunk=512), want, 1e-6)
    _close(ops.flash_attention(q, k, v, causal=False), want, 1e-6)


# --------------------------------------------------------------------------
# the tiny model: encode, decode_train, the prefill step, decode
# --------------------------------------------------------------------------

def _model(dtype, seed=0):
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams, flat = model_params(jcfg, seed)
    return jcfg, cfg, jparams, params_from_numpy(flat, cfg, "cpu")


def _maybe_jit(fn, dtype):
    return jax.jit(fn) if dtype == "float32" else fn


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_matches_jax(dtype):
    """The encoder memory (B2, 32 frames, two layers of bidirectional
    attention, LayerNorm, the GELU MLP) within the model tolerance."""
    jcfg, cfg, jparams, params = _model(dtype)
    jf, f = _frames(cfg, 2, 1, dtype)
    got = encdec.encode(params, f, cfg)
    want = _maybe_jit(lambda p, x: jencdec.encode(p, x, jcfg), dtype)(jparams, jf)
    assert got.dtype == f.dtype and got.shape == (2, cfg.enc_seq, cfg.d_model)
    assert float(np.abs(np.asarray(want, np.float32)).max()) > 1.0
    _close(got, want, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_train_logits_match_jax(dtype):
    """The teacher-forced decoder's fp32 logits over 12 tokens against the
    same memory (the reference's encoder output, so the decoder alone is
    held)."""
    jcfg, cfg, jparams, params = _model(dtype, seed=1)
    jf, _ = _frames(cfg, 2, 2, dtype)
    jmem = jencdec.encode(jparams, jf, jcfg)
    tokens = _rng(3).integers(0, cfg.vocab_size, (2, 12))
    want = _maybe_jit(lambda p, t, m: jencdec.decode_train(p, t, m, jcfg), dtype)(
        jparams, jnp.asarray(tokens, jnp.int32), jmem)
    mem = torch.from_numpy(np.array(jmem, np.float32)).to(DTYPES[dtype][1])
    got = encdec.decode_train(params, torch.from_numpy(tokens), mem, cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 12, cfg.vocab_size)
    _close(got, want, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_step_matches_jax(dtype):
    """``make_prefill_step``: (next token, memory, last logits) of frames and
    16 tokens; the token equal, the memory and last logits within the model
    tolerance."""
    jcfg, cfg, jparams, params = _model(dtype, seed=2)
    jf, f = _frames(cfg, 2, 4, dtype)
    tokens = _rng(5).integers(0, cfg.vocab_size, (2, 16))
    jnxt, jmem, jlast = _maybe_jit(jsteps.make_prefill_step(jcfg), dtype)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32), "frames": jf})
    nxt, mem, last = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(tokens), "frames": f})
    assert nxt.shape == (2, 1) and last.shape == (2, cfg.vocab_size)
    _close(mem, jmem, MODEL_TOL[dtype])
    _close(last, jlast, MODEL_TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_prefill_step_runs_the_flash_dispatch_bidirectional_then_causal(monkeypatch):
    """The prefill step reaches ``ops.flash_attention`` once a layer: the
    encoder's two calls bidirectional over the 32 frames, the decoder's two
    causal over the tokens; ``force`` reaches each."""
    _, cfg = _cfgs(dtype="float32")
    params = steps.init_params(cfg, 0)
    calls, flash = [], ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], kw["causal"], kw["force"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    f = torch.zeros((1, cfg.enc_seq, cfg.d_model))
    steps.make_prefill_step(cfg, force="ref")(params, {"tokens": torch.zeros((1, 8),
                                                                             dtype=torch.long),
                                                       "frames": f})
    assert calls == [(32, False, "ref")] * 2 + [(8, True, "ref")] * 2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_init_decode_state_matches_jax(dtype):
    """Per decoder layer: zeroed self-attention caches at capacity and the
    cross-attention's K/V of the memory in the state dtype."""
    jcfg, cfg, jparams, params = _model(dtype, seed=3)
    jf, _ = _frames(cfg, 2, 6, dtype)
    jmem = jencdec.encode(jparams, jf, jcfg)
    mem = torch.from_numpy(np.array(jmem, np.float32)).to(DTYPES[dtype][1])
    jst = jencdec.init_decode_state(jparams, jmem, jcfg, 2, 20, dtype=DTYPES[dtype][0])
    st = encdec.init_decode_state(params, mem, cfg, 2, 20, dtype=DTYPES[dtype][1])
    assert len(st) == len(jst) == cfg.n_layers
    for layer, jlayer in zip(st, jst):
        assert layer["self"].k.shape == (2, cfg.n_kv_heads, 20, cfg.hd)
        assert not bool(layer["self"].k.any()) and not bool(layer["self"].v.any())
        for got, want in zip(layer["cross_kv"], jlayer["cross_kv"]):
            assert got.dtype == DTYPES[dtype][1] and got.shape == (2, cfg.n_heads, 32, cfg.hd)
            _close(got, want, MODEL_TOL[dtype])


def _jax_greedy(jcfg, jparams, jframes, b, s_max, n):
    """The reference's greedy loop: its encoder (eagerly, for bf16 frames'
    roundings), the decode state in fp32, n jitted decode steps from token
    0. Returns (tokens (b, n), [each step's logits])."""
    jmem = jencdec.encode(jparams, jframes, jcfg)
    states = jencdec.init_decode_state(jparams, jmem, jcfg, b, s_max, dtype=jnp.float32)
    step = jax.jit(lambda p, t, st, c: jencdec.decode_step(p, t, st, c, jcfg))
    tok, toks, logits = jnp.zeros((b, 1), jnp.int32), [], []
    for i in range(n):
        lg, states = step(jparams, tok, states, jnp.int32(i))
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(tok))
    return np.concatenate(toks, axis=1), logits


def test_decode_steps_and_greedy_tokens_match_jax():
    """fp32: greedy decode from token 0 against the memory of 2 x 32 frames:
    each ``decode_step``'s logits within 1e-4 of the reference's and the 6
    tokens of ``make_decode_step``'s loop identical; the steps' logits equal
    the teacher-forced decoder's over the same tokens within 1e-4."""
    jcfg, cfg, jparams, params = _model("float32", seed=4)
    jf, f = _frames(cfg, 2, 7, "float32")
    jtoks, jlogits = _jax_greedy(jcfg, jparams, jf, 2, N_DECODE, N_DECODE)
    mem = encdec.encode(params, f, cfg)
    st = encdec.init_decode_state(params, mem, cfg, 2, N_DECODE, dtype=torch.float32)
    tok, inputs, logits = torch.zeros((2, 1), dtype=torch.long), [], []
    for i in range(N_DECODE):
        inputs.append(tok)
        lg, st = encdec.decode_step(params, tok, st, i, cfg)
        logits.append(lg)
        tok = torch.argmax(lg[:, -1:], dim=-1)
    for got, want in zip(logits, jlogits):
        _close(got, want, 1e-4)
    st = encdec.init_decode_state(params, mem, cfg, 2, N_DECODE, dtype=torch.float32)
    decode, tok, toks = steps.make_decode_step(cfg), torch.zeros((2, 1), dtype=torch.long), []
    for i in range(N_DECODE):
        tok, st = decode(params, tok, st, i)
        toks.append(tok)
    np.testing.assert_array_equal(torch.cat(toks, dim=1).numpy(), jtoks)
    want = encdec.decode_train(params, torch.cat(inputs, dim=1), mem, cfg)
    _close(torch.cat(logits, dim=1), want.numpy(), 1e-4)


def test_default_decode_state_dtype_and_the_engines_deviation(monkeypatch):
    """ROADMAP C.15: on the reference's bf16 default state dtype, its fp32
    decode step raises TypeError (its cache update mixes dtypes); the
    port's ``init_decode_state`` has no default and its engine passes the
    config's dtype, so an fp32 engine decodes, and its tokens are the
    reference's loop's with the state in fp32."""
    jcfg, cfg, jparams, params = _model("float32", seed=5)
    jf, _ = _frames(cfg, 1, 8, "float32")
    jmem = jencdec.encode(jparams, jf, jcfg)
    jst = jencdec.init_decode_state(jparams, jmem, jcfg, 1, 4)
    with pytest.raises(TypeError):
        jencdec.decode_step(jparams, jnp.zeros((1, 1), jnp.int32), jst, jnp.int32(0), jcfg)
    monkeypatch.setattr(serve_cli, "get_tiny_config", lambda arch: cfg)  # fp32
    engine = ServeEngine(ARCH, device="cpu", params=params)
    gen = torch.Generator().manual_seed(0)
    frames = torch.randn((1, cfg.enc_seq, cfg.d_model), generator=gen).to(torch.bfloat16)
    out = engine.generate(torch.zeros((1, 3), dtype=torch.long), 4)
    jtoks, _ = _jax_greedy(jcfg, jparams, jnp.asarray(frames.float().numpy()).astype(
        jnp.bfloat16), 1, 7, 3)
    np.testing.assert_array_equal(out["tokens"][:, 1:].numpy(), jtoks)


def test_steps_decode_state_raises_as_the_reference():
    jcfg, cfg = _cfgs()
    with pytest.raises(ValueError, match="init_decode_state"):
        steps.decode_state(cfg, 2, 8)
    with pytest.raises(ValueError, match="init_decode_state"):
        jsteps.decode_state(jcfg, 2, 8)


def test_bf16_frames_keep_the_memory_bf16_under_fp32_weights():
    """The encoder rounds the positions to the frames' dtype: bf16 frames
    through fp32 weights give a bf16 memory, as the reference's do, within
    the bf16 tolerance of it."""
    jcfg, cfg, jparams, params = _model("float32", seed=6)
    jf, f = _frames(cfg, 2, 9, "bfloat16")
    want = jencdec.encode(jparams, jf, jcfg)
    got = encdec.encode(params, f, cfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, MODEL_TOL["bfloat16"])


# --------------------------------------------------------------------------
# ServeEngine and the serve CLI on tiny whisper
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    return ServeEngine(ARCH, tiny=True, device="cpu")


def test_generate_is_encode_then_greedy_decode(engine):
    """``generate`` draws bf16 frames from the engine's generator, encodes
    them, and decodes greedily from token 0 at position 0 (the prompt's
    shape sets the batch and the capacity; prefill_s is 0): its tokens are
    those of the same loop written out on the same frames."""
    other = ServeEngine(ARCH, tiny=True, device="cpu")
    prompts = torch.zeros((2, 5), dtype=torch.long)
    out = other.generate(prompts, 4)
    assert out["tokens"].shape == (2, 4) and out["prefill_s"] == 0.0 and out["decode_s"] > 0
    cfg = other.cfg
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model),
                         generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    mem = encdec.encode(other.params, frames, cfg)
    st = encdec.init_decode_state(other.params, mem, cfg, 2, 9, torch.bfloat16)
    tok, toks = torch.zeros((2, 1), dtype=torch.long), []
    for i in range(4):
        toks.append(tok)
        lg, st = encdec.decode_step(other.params, tok, st, i, cfg)
        tok = torch.argmax(lg[:, -1:], dim=-1)
    assert torch.equal(out["tokens"], torch.cat(toks, dim=1))
    assert bool((out["tokens"][:, 0] == 0).all())


def test_generate_is_deterministic_per_seed(engine):
    a = ServeEngine(ARCH, tiny=True, device="cpu", seed=3)
    b = ServeEngine(ARCH, tiny=True, device="cpu", seed=3)
    prompts = torch.zeros((2, 4), dtype=torch.long)
    assert torch.equal(a.generate(prompts, 5)["tokens"], b.generate(prompts, 5)["tokens"])


def test_infer_payload_knobs(engine):
    ops.reset_launch_counts()
    out = engine.infer({"prompt_len": 8, "gen": 4, "batch": 2})
    assert out["arch"] == ARCH and out["batch"] == 2 and out["prompt_len"] == 8
    assert len(out["tokens"]) == 4 and out["tokens"][0] == 0
    assert all(0 <= t < engine.cfg.vocab_size for t in out["tokens"])
    assert out["decode_ms_per_token"] > 0
    assert ops.launch_counts()["flash_attention"] == 0  # the CPU runs the plain versions


def test_serve_cli_runs_tiny_whisper(capsys):
    """The serve CLI on whisper: no prefill line (prefill_s is 0, as in the
    reference's CLI), the decode line and a sample continuation."""
    serve_cli.main(["--arch", ARCH, "--tiny", "--device", "cpu", "--requests", "2",
                    "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=whisper-tiny-tiny" in out and "decode:" in out and "prefill:" not in out
    assert "sample continuation (req 0): [0," in out
