"""The port's recurrentgemma-2b serving slice (repro_torch.nn.recurrent, the
rglru block, the hybrid list-layout stack) against the JAX package, module
by module and end to end, on the CPU.

The JAX package materializes the params; ``repro_torch.convert`` loads
them, so both packages run the same weights. Inputs are made with numpy
from a fixed seed. Modules are held to 1e-5 in fp32 and 2e-2 in bf16; the
whole model to 1e-4 in fp32 (the reference runs an associative scan where
the port runs the sequential one, and sums in another order) and 5e-2 on
bf16 logits (the port rounds the gate projection to bf16 before the gelu,
as its MLP does before the silu, and keeps attention's softmax in fp32).
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
from repro.launch.serve import _install_prefill as j_install_prefill
from repro.models import lm as jlm
from repro.models import steps as jsteps
from repro.nn import blocks as jblocks
from repro.nn import params as jprm
from repro.nn import recurrent as jrec
from repro.utils.trees import path_str
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeEngine, _install_prefill
from repro_torch.models import lm, steps
from repro_torch.nn import blocks, recurrent
from repro_torch.nn.attention import KVCache
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

ARCH = "recurrentgemma-2b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np_tree(jtree):
    return {p: np.asarray(x) for p, x in jflatten(jtree)}


def _to(arr, dtype):
    """numpy fp32 → (jax array, torch tensor) in ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    arr = np.array(arr, np.float32)
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _trees(flat, dtype):
    """{path: np array} → (jax tree, torch tree) in ``dtype``; lam and norm
    scales stay fp32, as the models keep them."""
    keep = ("lam", "scale")
    jt, tt = {}, {}
    for p, a in flat.items():
        d = "float32" if p.rsplit("/", 1)[-1] in keep else dtype
        jt[p], tt[p] = _to(a, d)
    return tree_unflatten(jt), tree_unflatten(tt)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# configs, def-tree, params
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tiny", [False, True])
def test_configs_equal_field_by_field(tiny):
    jcfg = jget_tiny(ARCH) if tiny else jget_config(ARCH)
    cfg = get_tiny_config(ARCH) if tiny else get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.hd == jcfg.hd and cfg.param_count() == jcfg.param_count()
    assert cfg.pattern_for_layers() == jcfg.pattern_for_layers()


def _def_leaves(defs, is_def):
    return {path_str(p): d for p, d in
            jax.tree_util.tree_flatten_with_path(defs, is_leaf=is_def)[0]}


def test_full_width_def_tree_matches_jax():
    """26 layers (18 rglru + 8 attn) in the list layout: paths, shapes,
    inits and dtypes equal the reference's. The leaves hold 2,682,237,440
    params; ``param_count()``, an estimate, says 2,693,713,920."""
    jleaves = _def_leaves(jsteps.model_defs(jget_config(ARCH)),
                          lambda x: isinstance(x, jprm.ParamDef))
    want = {p: (tuple(d.shape), d.init, d.scale, d.dtype) for p, d in jleaves.items()}
    got = {p: (tuple(d.shape), d.init, d.scale, d.dtype)
           for p, d in tree_flatten_with_paths(steps.model_defs(get_config(ARCH)))}
    assert got == want
    assert got["blocks/layers/0/lru/lam"] == ((2560,), "zeros", None, "float32")
    assert got["blocks/layers/2/attn/wk"][0] == (2560, 1, 256)
    assert got["blocks/layers/0/lru/a_gate/w"][0] == (10, 256, 256)
    assert sum(math.prod(s) for s, *_ in got.values()) == 2_682_237_440
    assert get_config(ARCH).param_count() == 2_693_713_920
    kinds = get_config(ARCH).pattern_for_layers()
    assert kinds.count("rglru") == 18 and kinds.count("attn") == 8


def test_params_from_numpy_loads_reference_params():
    jcfg, cfg = jget_tiny(ARCH), get_tiny_config(ARCH)
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(0)))
    params = params_from_numpy(flat, cfg, "cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_flatten_with_paths(params)}
    own = {p: (tuple(t.shape), t.dtype)
           for p, t in tree_flatten_with_paths(steps.init_params(cfg, seed=0))}
    assert got == own and set(got) == set(flat)
    assert got["blocks/layers/0/lru/lam"][1] == torch.float32
    assert got["blocks/layers/0/conv/w"] == ((4, 64), torch.bfloat16)
    assert np.array_equal(params["blocks"]["layers"][1]["w_x"].view(torch.int16).numpy(),
                          flat["blocks/layers/1/w_x"].view(np.int16))


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv_matches_jax(dtype):
    rng = _rng(1)
    jp, p = _trees({"w": rng.standard_normal((4, 48)), "b": rng.standard_normal(48)}, dtype)
    jx, x = _to(rng.standard_normal((2, 11, 48)), dtype)
    _close(recurrent.causal_conv(p, x), jrec.causal_conv(jp, jx), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv_step_matches_jax(dtype):
    rng = _rng(2)
    jp, p = _trees({"w": rng.standard_normal((4, 48)), "b": rng.standard_normal(48)}, dtype)
    jx, x = _to(rng.standard_normal((2, 48)), dtype)
    jst, st = _to(rng.standard_normal((2, 3, 48)), dtype)
    y, new = recurrent.causal_conv_step(p, x, st)
    jy, jnew = jrec.causal_conv_step(jp, jx, jst)
    _close(y, jy, DTYPES[dtype][2])
    _close(new, jnew, 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blockdiag_matches_jax(dtype):
    rng = _rng(3)
    jp, p = _trees({"w": rng.standard_normal((2, 16, 16)) / 4,
                    "b": rng.standard_normal((2, 16))}, dtype)
    jx, x = _to(rng.standard_normal((3, 5, 2, 16)), dtype)
    y = recurrent.blockdiag(p, x)
    assert y.dtype == x.dtype  # rounded to x's dtype before the gates' sigmoid
    _close(y, jrec.blockdiag(jp, jx), DTYPES[dtype][2])


def _lru_flat(w=64, n_heads=2, seed=4):
    rng = _rng(seed)
    bw = w // n_heads
    return {"a_gate/w": rng.standard_normal((n_heads, bw, bw)) / math.sqrt(bw),
            "a_gate/b": rng.standard_normal((n_heads, bw)),
            "i_gate/w": rng.standard_normal((n_heads, bw, bw)) / math.sqrt(bw),
            "i_gate/b": rng.standard_normal((n_heads, bw)),
            "lam": rng.standard_normal(w)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_matches_jax(dtype, with_h0):
    jp, p = _trees(_lru_flat(), dtype)
    rng = _rng(5)
    jx, x = _to(rng.standard_normal((2, 23, 64)), dtype)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 else None
    y, h_last = recurrent.rglru(p, x, 2, None if h0 is None else torch.from_numpy(h0))
    jy, jh_last = jrec.rglru(jp, jx, 2, None if h0 is None else jnp.asarray(h0))
    assert y.dtype == x.dtype and h_last.dtype == torch.float32
    tol = DTYPES[dtype][2]
    _close(y, jy, tol)
    _close(h_last, jh_last, tol)
    # the port's step-by-step oracle agrees with the reference's
    _close(recurrent.rglru_ref(p, x, 2, None if h0 is None else torch.from_numpy(h0)),
           jrec.rglru_ref(jp, jx, 2, None if h0 is None else jnp.asarray(h0)), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_step_matches_jax(dtype):
    jp, p = _trees(_lru_flat(), dtype)
    rng = _rng(6)
    jx, x = _to(rng.standard_normal((2, 64)), dtype)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    y, h_new = recurrent.rglru_step(p, x, torch.from_numpy(h), 2)
    jy, jh_new = jrec.rglru_step(jp, jx, jnp.asarray(h), 2)
    _close(y, jy, DTYPES[dtype][2])
    _close(h_new, jh_new, DTYPES[dtype][2])


def _block(dtype, seed=7):
    """The tiny config's rglru block, reference-initialized, with a nonzero
    lam and conv bias so that every term is exercised."""
    jcfg, cfg = jget_tiny(ARCH), get_tiny_config(ARCH)
    flat = _np_tree(jprm.materialize(jax.random.key(seed),
                                     jblocks.def_rglru_block(jcfg), jnp.float32))
    rng = _rng(seed)
    flat["lru/lam"] = rng.standard_normal(flat["lru/lam"].shape).astype(np.float32)
    flat["conv/b"] = 0.1 * rng.standard_normal(flat["conv/b"].shape).astype(np.float32)
    jp, p = _trees(flat, dtype)
    return jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype), jp, p


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_rglru_block_prefill_matches_jax(dtype):
    jcfg, cfg, jp, p = _block(dtype)
    jx, x = _to(_rng(8).standard_normal((2, 9, 64)), dtype)
    y, st = blocks.apply_rglru_block(p, x, cfg, mode="prefill")
    jy, jst, _ = jblocks.apply_rglru_block(jp, jx, jcfg, mode="prefill")
    tol = DTYPES[dtype][2]
    _close(y, jy, tol)
    _close(st["conv"], jst["conv"], tol)  # the pre-conv inputs' last 3 steps
    _close(st["h"], jst["h"], tol)
    assert st["h"].dtype == torch.float32 and st["conv"].shape == (2, 3, 64)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_rglru_block_decode_matches_jax(dtype):
    jcfg, cfg, jp, p = _block(dtype)
    rng = _rng(9)
    jx, x = _to(rng.standard_normal((2, 1, 64)), dtype)
    jconv, conv = _to(rng.standard_normal((2, 3, 64)), dtype)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    y, st = blocks.apply_rglru_block(p, x, cfg, mode="decode",
                                     state={"conv": conv, "h": torch.from_numpy(h)})
    jy, jst, _ = jblocks.apply_rglru_block(jp, jx, jcfg, mode="decode",
                                           state={"conv": jconv, "h": jnp.asarray(h)})
    tol = DTYPES[dtype][2]
    _close(y, jy, tol)
    _close(st["conv"], jst["conv"], tol)
    _close(st["h"], jst["h"], tol)


def test_rglru_block_prefill_of_short_prompt_pads_conv_state():
    """A prompt shorter than the conv history leaves zeros before it, as
    a decode state that starts from zero would."""
    _, cfg, _, p = _block("float32")
    x = torch.from_numpy(_rng(10).standard_normal((1, 2, 64)).astype(np.float32))
    _, st = blocks.apply_rglru_block(p, x, cfg, mode="prefill")
    state = blocks.init_block_state(cfg, "rglru", 1, 8, torch.float32)
    for t in range(2):
        _, state = blocks.apply_rglru_block(p, x[:, t:t + 1], cfg, mode="decode",
                                            state=state)
    _close(st["conv"], state["conv"].numpy(), 1e-6)
    _close(st["h"], state["h"].numpy(), 1e-5)


# --------------------------------------------------------------------------
# the slice end to end on tiny recurrentgemma
# --------------------------------------------------------------------------

def _jax_serve(jcfg, jparams, prompts, n_decode):
    jp = jnp.asarray(prompts, jnp.int32)
    logits, _, _ = jlm.lm_apply(jparams, jp, jcfg, mode="prefill")
    tok, pf_states, _ = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, {"tokens": jp})
    b, s = prompts.shape
    states = jsteps.decode_state(jcfg, b, s + n_decode + 1)
    states = j_install_prefill(states, pf_states, jcfg, s)
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    toks = [np.asarray(tok)]
    for i in range(n_decode):
        tok, states = decode(jparams, tok, states, jnp.int32(s + i))
        toks.append(np.asarray(tok))
    return np.asarray(logits), pf_states, states, np.concatenate(toks, axis=1)


def _port_serve(cfg, params, prompts, n_decode):
    tp = torch.from_numpy(prompts).long()
    logits, _ = lm.lm_apply(params, tp, cfg, mode="prefill")
    tok, pf_states, _ = steps.make_prefill_step(cfg)(params, {"tokens": tp})
    b, s = prompts.shape
    states = _install_prefill(steps.decode_state(cfg, b, s + n_decode + 1), pf_states)
    decode = steps.make_decode_step(cfg)
    toks = [tok]
    for i in range(n_decode):
        tok, states = decode(params, tok, states, s + i)
        toks.append(tok)
    return logits, pf_states, states, torch.cat(toks, dim=1).numpy()


def _assert_states_close(states, jstates, kinds, tol):
    assert len(states) == len(jstates) == len(kinds)
    for kind, st, jst in zip(kinds, states, jstates):
        if kind == "attn":
            assert isinstance(st, KVCache)
            pairs = ((st.k, jst.k), (st.v, jst.v))
        else:
            assert st["h"].dtype == torch.float32
            pairs = ((st["conv"], jst["conv"]), (st["h"], jst["h"]))
        for got, want in pairs:
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, tol)


def test_slice_fp32_matches_jax():
    """fp32, prompt of 40 > the tiny window of 32: prefill logits, KV caches
    and rglru conv/h states within 1e-4, then greedy tokens over 6 decode
    steps identical to the reference serving loop, and the decode states
    after them within 1e-4."""
    jcfg, cfg = jget_tiny(ARCH).replace(dtype="float32"), \
        get_tiny_config(ARCH).replace(dtype="float32")
    jparams = jsteps.init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(_np_tree(jparams), cfg, "cpu")
    prompts = _rng(11).integers(0, cfg.vocab_size, (2, 40))
    jlogits, jpf, jdec, jtoks = _jax_serve(jcfg, jparams, prompts, 6)
    logits, pf, dec, toks = _port_serve(cfg, params, prompts, 6)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
    kinds = cfg.pattern_for_layers()
    assert kinds == ("rglru", "rglru", "attn")
    _assert_states_close(pf, jpf, kinds, 1e-4)
    assert toks.shape == (2, 7)
    np.testing.assert_array_equal(toks, jtoks)
    _assert_states_close(dec, jdec, kinds, 1e-4)


def _true_fan_in(jparams, cfg):
    """The attention projections rescaled to their true fan-in. The
    reference init divides by the heads axis (``_fan_in`` takes shape[-2]),
    which is 1 for MQA's wk/wv: k gets std 1 instead of 1/8 and attention is
    nearly one-hot, so one bf16 rounding that differs can move a logit by
    more than the tolerance (0.077 on one of 8 prompts here, against at most
    0.0103 on these weights)."""
    d, hd = cfg.d_model, cfg.hd
    rescale = {"wq": math.sqrt(cfg.n_heads / d), "wk": math.sqrt(cfg.n_kv_heads / d),
               "wv": math.sqrt(cfg.n_kv_heads / d), "wo": math.sqrt(hd / (cfg.n_heads * hd))}

    def scale(path, x):
        p = path_str(path)
        name = p.rsplit("/", 1)[-1]
        if "/attn/" not in p or name not in rescale:
            return x
        return (x.astype(jnp.float32) * rescale[name]).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(scale, jparams)


def test_slice_bf16_prefill_logits_match_jax():
    """bf16 last logits within 5e-2, on the reference's weights with the
    attention projections at their true fan-in (``_true_fan_in``)."""
    jcfg, cfg = jget_tiny(ARCH), get_tiny_config(ARCH)
    jparams = _true_fan_in(jsteps.init_params(jcfg, jax.random.key(0)), cfg)
    params = params_from_numpy(_np_tree(jparams), cfg, "cpu")
    prompts = _rng(12).integers(0, cfg.vocab_size, (2, 40))
    _, _, jlast = jax.jit(jsteps.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
    _, _, last = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(prompts).long()})
    assert last.dtype == torch.float32
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=5e-2, rtol=5e-2)


def test_decode_state_is_per_kind():
    cfg = get_tiny_config(ARCH)
    states = steps.decode_state(cfg, 2, 50)
    assert isinstance(states[2], KVCache) and states[2].k.shape == (2, 1, 50, 32)
    assert states[0]["conv"].shape == (2, 3, 64)
    assert states[0]["conv"].dtype == torch.bfloat16
    assert states[0]["h"].shape == (2, 64) and states[0]["h"].dtype == torch.float32


def test_force_kernel_on_cpu_raises_in_the_model():
    cfg = get_tiny_config(ARCH)
    params = steps.init_params(cfg, seed=0)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        steps.make_prefill_step(cfg, force="kernel")(params, {"tokens": tokens})
    assert ops.launch_counts() == before


# --------------------------------------------------------------------------
# ServeEngine on tiny recurrentgemma
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    return ServeEngine(ARCH, tiny=True, device="cpu")


def test_generate_shapes_and_timings(engine):
    B, S, gen = 2, 40, 4
    out = engine.generate(engine.synthetic_prompts(B, S), gen)
    assert out["tokens"].shape == (B, gen)
    assert bool((out["tokens"] >= 0).all())
    assert bool((out["tokens"] < engine.cfg.vocab_size).all())
    assert out["prefill_s"] > 0 and out["decode_s"] > 0


def test_generate_is_deterministic_per_batch(engine):
    prompts = engine.synthetic_prompts(1, 12)
    assert torch.equal(engine.generate(prompts, 4)["tokens"],
                       engine.generate(prompts, 4)["tokens"])


def test_generate_runs_no_kernel_on_cpu(engine):
    ops.reset_launch_counts()
    engine.generate(engine.synthetic_prompts(1, 8), 3)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "rglru_scan": 0, "rglru_scan_bwd": 0}


def test_infer_payload_knobs(engine):
    out = engine.infer({"prompt_len": 8, "gen": 4, "batch": 2})
    assert out["arch"] == ARCH and out["batch"] == 2 and out["prompt_len"] == 8
    assert len(out["tokens"]) == 4
    assert out["decode_ms_per_token"] > 0
