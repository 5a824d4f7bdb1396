"""The port's serving slice (repro_torch) against the JAX package, module
by module and end to end, on the CPU.

The JAX package materializes the params; ``repro_torch.convert`` loads
them, so both packages run the same weights. Inputs are made with numpy
from a fixed seed. fp32 comparisons use 1e-5 per module and 1e-4 for the
whole model; in bf16 the port keeps q·scale and the softmax probabilities
in fp32 inside attention where the reference's chunked twin rounds them to
bf16 (nn/attention.py:95, :126), hence 5e-2 on the logits.
"""

import dataclasses

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
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import mlp as jmlp
from repro.nn import params as jprm
from repro.utils.trees import path_str
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeEngine, _install_prefill
from repro_torch.models import lm, steps
from repro_torch.nn import attention, layers, mlp
from repro_torch.nn import params as prm
from repro_torch.utils.trees import (tree_flatten_with_paths, tree_map_with_path,
                                     tree_unflatten)

ARCH = "smollm-360m"
LAYOUTS = {"list": {}, "stacked": {"scan_layers": True}}


def _np_tree(jtree):
    return {p: np.asarray(x) for p, x in jflatten(jtree)}


def _torch_tree(jtree):
    """JAX fp32 tree → the same tree of torch tensors."""
    return tree_unflatten({p: torch.from_numpy(a.copy())
                           for p, a in _np_tree(jtree).items()})


def _cfgs(**kw):
    return (jget_tiny(ARCH).replace(**kw), get_tiny_config(ARCH).replace(**kw))


def _rng(seed=0):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# configs, trees, params
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tiny", [False, True])
def test_configs_equal_field_by_field(tiny):
    jcfg = jget_tiny(ARCH) if tiny else jget_config(ARCH)
    cfg = get_tiny_config(ARCH) if tiny else get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.hd == jcfg.hd and cfg.param_count() == jcfg.param_count()


def test_unported_arch_raises_naming_roadmap():
    """An arch id the port does not know raises, naming ROADMAP.md; all ten
    of the reference's resolve."""
    for lookup in (get_config, get_tiny_config):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            lookup("whisper-large")
    assert get_config("whisper-tiny").is_encoder_decoder


@pytest.mark.parametrize("change", [{"rms_norm": False}, {"act": "gelu"},
                                    {"is_encoder_decoder": True}])
def test_unported_model_features_raise(change):
    """The three model features the port once refused (LayerNorm, the
    ungated GELU MLP, the encoder-decoder) no longer raise: each builds the
    reference's def-tree (paths, shapes, inits, scales, dtypes: LayerNorm's
    fp32 bias, no gate leaf for gelu, the encoder-decoder's tree). The LM
    path runs the first two: the tiny smollm's fp32 prefill logits within
    1e-4 of the reference's, with the norms' scales and biases redrawn
    nonzero."""
    jcfg, cfg = _cfgs(dtype="float32", **change)
    is_def = lambda x: isinstance(x, jprm.ParamDef)  # noqa: E731
    want = {path_str(p): (tuple(d.shape), d.init, d.scale, d.dtype) for p, d in
            jax.tree_util.tree_flatten_with_path(jsteps.model_defs(jcfg), is_leaf=is_def)[0]}
    got = {p: (tuple(d.shape), d.init, d.scale, d.dtype)
           for p, d in tree_flatten_with_paths(steps.model_defs(cfg))}
    assert got == want
    if cfg.is_encoder_decoder:
        assert "enc_norm/bias" not in got and "dec/0/cross/wq" in got  # rms_norm stays on
        return
    assert ("blocks/layers/0/norm1/bias" in got) == (not cfg.rms_norm)
    assert ("blocks/layers/0/mlp/gate" in got) == (cfg.act == "silu")
    rng = _rng(3)
    flat = {p: (a if p.rsplit("/", 1)[-1] not in ("scale", "bias") else
                (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32))
            for p, a in _np_tree(jsteps.init_params(jcfg, jax.random.key(0))).items()}
    jparams = tree_unflatten({p: jnp.asarray(a) for p, a in flat.items()})
    prompts = _rng(9).integers(0, cfg.vocab_size, (2, 12))
    jlogits, _, _ = jlm.lm_apply(jparams, jnp.asarray(prompts, jnp.int32), jcfg, mode="prefill")
    logits, _ = lm.lm_apply(params_from_numpy(flat, cfg, "cpu"), torch.from_numpy(prompts),
                            cfg, mode="prefill")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)


def test_tree_paths_match_reference_and_round_trip():
    tree = {"b": [{"x": 1}, {"x": 2}], "a": {"k": 3}}
    flat = tree_flatten_with_paths(tree)
    assert flat == [(p, x) for p, x in jflatten(tree)]
    assert tree_unflatten(dict(flat)) == tree
    assert tree_map_with_path(lambda p, x: p, tree)["b"][1]["x"] == "b/1/x"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_params_from_numpy_matches_port_def_tree(layout):
    jcfg, cfg = _cfgs(**LAYOUTS[layout])
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(0)))
    params = params_from_numpy(flat, cfg, "cpu")
    own = steps.init_params(cfg, seed=0)
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_flatten_with_paths(params)}
    want = {p: (tuple(t.shape), t.dtype) for p, t in tree_flatten_with_paths(own)}
    assert got == want
    assert set(got) == set(flat)
    key = "blocks/scan/attn/wq" if layout == "stacked" else "blocks/layers/1/attn/wq"
    assert key in got
    assert got["blocks/" + key.split("/", 1)[1]][1] == torch.bfloat16
    norm = key.rsplit("/", 2)[0] + "/norm1/scale"
    assert got[norm][1] == torch.float32  # norm scales stay fp32
    # bf16 bits come through unchanged
    src = flat["embed"]
    assert np.array_equal(params["embed"].view(torch.int16).numpy(),
                          src.view(np.int16))


def test_params_from_numpy_rejects_mismatches():
    jcfg, cfg = _cfgs()
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(0)))
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items() if k != "embed"}, cfg, "cpu")
    bad = dict(flat, embed=flat["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, cfg, "cpu")
    bad = dict(flat, embed=flat["embed"].astype(np.float32))
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, cfg, "cpu")


def test_materialize_is_deterministic_per_seed():
    _, cfg = _cfgs(scan_layers=True)
    a, b = steps.init_params(cfg, seed=3), steps.init_params(cfg, seed=3)
    c = steps.init_params(cfg, seed=4)
    fa, fb, fc = (dict(tree_flatten_with_paths(t)) for t in (a, b, c))
    assert all(torch.equal(fa[p], fb[p]) for p in fa)
    assert not torch.equal(fa["embed"], fc["embed"])
    # each leaf has its own stream, seeded by its path: leaves of one shape
    # and init differ, and so do the layers of the stack
    assert not torch.equal(fa["blocks/scan/attn/wk"], fa["blocks/scan/attn/wv"])
    wq = fa["blocks/scan/attn/wq"]
    assert not torch.equal(wq[0], wq[1])
    assert torch.equal(fa["blocks/scan/norm1/scale"],
                       torch.ones_like(fa["blocks/scan/norm1/scale"]))


@pytest.mark.parametrize("window", [1, 1 << 12, 1 << 30])
def test_materialize_on_threads_equals_the_calling_threads_draw(monkeypatch, window):
    """A full-width model's leaves are drawn on a pool of threads within a
    window of bytes; the weights are those of the calling thread's draw,
    bit for bit, whatever the window (one leaf at a time, a few, all)."""
    _, cfg = _cfgs(scan_layers=True)
    serial = dict(tree_flatten_with_paths(steps.init_params(cfg, seed=5)))
    monkeypatch.setattr(prm, "DRAW_POOL_MIN_BYTES", 0)
    monkeypatch.setattr(prm, "DRAW_WINDOW_BYTES", window)
    pooled = tree_flatten_with_paths(steps.init_params(cfg, seed=5))
    assert [p for p, _ in pooled] == list(serial)
    assert all(t.dtype == serial[p].dtype and torch.equal(t, serial[p]) for p, t in pooled)


# --------------------------------------------------------------------------
# modules, fp32 at 1e-5
# --------------------------------------------------------------------------

def _close(port, ref, tol=1e-5):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_rmsnorm_matches_jax():
    x = _rng().standard_normal((2, 5, 64), np.float32)
    scale = _rng(1).standard_normal(64, np.float32)
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


def test_apply_rope_matches_jax():
    x = _rng().standard_normal((2, 3, 7, 16), np.float32)
    pos = np.broadcast_to(np.arange(100, 107), (2, 7)).copy()
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)[:, None, :]),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos)[:, None, :]))


def test_mlp_matches_jax():
    jp = jprm.materialize(jax.random.key(1), jmlp.def_mlp(64, 128), jnp.float32)
    x = _rng().standard_normal((2, 5, 64), np.float32)
    _close(mlp.mlp(_torch_tree(jp), torch.from_numpy(x)),
           jmlp.mlp(jp, jnp.asarray(x)))


def _attn_inputs(d=64, h=4, kv=2, hd=16, b=2, s=12):
    jp = jprm.materialize(jax.random.key(2), jattn.def_gqa(d, h, kv, hd), jnp.float32)
    # scaled so that outputs are O(1), where fp32 resolves 1e-5
    x = 0.25 * _rng().standard_normal((b, s, d), np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return jp, _torch_tree(jp), x, pos


def test_gqa_attention_prefill_matches_jax():
    jp, p, x, pos = _attn_inputs()
    jy, jcache = jattn.gqa_attention(jp, jnp.asarray(x), n_heads=4, n_kv_heads=2,
                                     head_dim=16, positions=jnp.asarray(pos),
                                     chunk=4, mode="prefill")
    y, cache = attention.gqa_attention(p, torch.from_numpy(x),
                                       positions=torch.from_numpy(pos),
                                       mode="prefill")
    _close(y, jy)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


def test_gqa_attention_decode_matches_jax():
    jp, p, x, pos = _attn_inputs(s=1)
    cache_np = [_rng(i).standard_normal((2, 2, 9, 16), np.float32) for i in (3, 4)]
    jcache = jattn.KVCache(*(jnp.asarray(c) for c in cache_np))
    cache = attention.KVCache(*(torch.from_numpy(c.copy()) for c in cache_np))
    cache_len = 5
    jy, jnew = jattn.gqa_attention(
        jp, jnp.asarray(x), n_heads=4, n_kv_heads=2, head_dim=16,
        positions=jnp.full((2, 1), cache_len, jnp.int32), cache=jcache,
        cache_len=jnp.int32(cache_len), mode="decode")
    y, new = attention.gqa_attention(
        p, torch.from_numpy(x), positions=torch.full((2, 1), cache_len),
        cache=cache, cache_len=cache_len, mode="decode")
    _close(y, jy)
    _close(new.k, jnew.k)
    _close(new.v, jnew.v)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (True, 3, 4),
                                                    (False, 0, 0)])
def test_naive_attention_matches_jax(causal, window, q_offset):
    rng = _rng(5)
    q = rng.standard_normal((2, 4, 6, 16), np.float32)
    k, v = (rng.standard_normal((2, 2, 10, 16), np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(attention.naive_attention(*map(torch.from_numpy, (q, k, v)), **kw),
           jattn.naive_attention(*map(jnp.asarray, (q, k, v)), **kw))


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------

def _jax_serve(jcfg, jparams, prompts, n_decode):
    jp = jnp.asarray(prompts, jnp.int32)
    logits, pf_states, _ = jlm.lm_apply(jparams, jp, jcfg, mode="prefill")
    tok, pf_states, _ = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, {"tokens": jp})
    b, s = prompts.shape
    states = jsteps.decode_state(jcfg, b, s + n_decode + 1)
    states = j_install_prefill(states, pf_states, jcfg, s)
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    toks = [np.asarray(tok)]
    for i in range(n_decode):
        tok, states = decode(jparams, tok, states, jnp.int32(s + i))
        toks.append(np.asarray(tok))
    return np.asarray(logits), pf_states, np.concatenate(toks, axis=1)


def _port_serve(cfg, params, prompts, n_decode):
    tp = torch.from_numpy(prompts).long()
    logits, pf_states = lm.lm_apply(params, tp, cfg, mode="prefill")
    tok, pf_states, _ = steps.make_prefill_step(cfg)(params, {"tokens": tp})
    b, s = prompts.shape
    states = _install_prefill(steps.decode_state(cfg, b, s + n_decode + 1), pf_states)
    decode = steps.make_decode_step(cfg)
    toks = [tok]
    for i in range(n_decode):
        tok, states = decode(params, tok, states, s + i)
        toks.append(tok)
    return logits, pf_states, torch.cat(toks, dim=1).numpy()


def _caches(states):
    """[(k, v)] per layer of either layout, as numpy fp32."""
    if isinstance(states, list):
        return [(np.asarray(c.k, np.float32), np.asarray(c.v, np.float32))
                for c in states]
    return [(np.asarray(states.k, np.float32), np.asarray(states.v, np.float32))]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_slice_fp32_matches_jax(layout):
    """fp32: prefill logits and KV caches within 1e-4, then greedy tokens
    over 6 decode steps identical to the reference serving loop."""
    jcfg, cfg = _cfgs(dtype="float32", **LAYOUTS[layout])
    jparams = jsteps.init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(_np_tree(jparams), cfg, "cpu")
    prompts = _rng(7).integers(0, cfg.vocab_size, (2, 12))
    jlogits, jstates, jtoks = _jax_serve(jcfg, jparams, prompts, 6)
    logits, states, toks = _port_serve(cfg, params, prompts, 6)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
    for (k, v), (jk, jv) in zip(_caches(_torch_np(states)), _caches(jstates)):
        np.testing.assert_allclose(k, jk, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(v, jv, atol=1e-4, rtol=1e-4)
    assert toks.shape == (2, 7)
    np.testing.assert_array_equal(toks, jtoks)


def _torch_np(states):
    to = lambda c: attention.KVCache(c.k.float().numpy(), c.v.float().numpy())
    return [to(c) for c in states] if isinstance(states, list) else to(states)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_slice_bf16_prefill_logits_match_jax(layout):
    jcfg, cfg = _cfgs(**LAYOUTS[layout])
    jparams = jsteps.init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(_np_tree(jparams), cfg, "cpu")
    prompts = _rng(8).integers(0, cfg.vocab_size, (2, 16))
    _, _, jlast = jax.jit(jsteps.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
    _, _, last = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(prompts).long()})
    assert last.dtype == torch.float32
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=5e-2, rtol=5e-2)


def test_full_width_def_tree_matches_jax():
    """The full config's stacked def-tree: paths, shapes, inits, dtypes."""
    jleaves = jax.tree_util.tree_flatten_with_path(
        jsteps.model_defs(jget_config(ARCH)),
        is_leaf=lambda x: isinstance(x, jprm.ParamDef))[0]
    want = {path_str(p): (tuple(d.shape), d.init, d.scale, d.dtype)
            for p, d in jleaves}
    got = {p: (tuple(d.shape), d.init, d.scale, d.dtype)
           for p, d in tree_flatten_with_paths(steps.model_defs(get_config(ARCH)))}
    assert got == want
    assert got["blocks/scan/attn/wq"][0] == (32, 960, 15, 64)


# --------------------------------------------------------------------------
# ServeEngine, as tests/test_serve_engine.py drives the reference's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    return ServeEngine(ARCH, tiny=True, device="cpu")


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(ARCH, tiny=True)


def test_generate_shapes_and_timings(engine):
    B, S, gen = 2, 8, 4
    out = engine.generate(engine.synthetic_prompts(B, S), gen)
    assert out["tokens"].shape == (B, gen)
    assert bool((out["tokens"] >= 0).all())
    assert bool((out["tokens"] < engine.cfg.vocab_size).all())
    assert out["prefill_s"] > 0 and out["decode_s"] > 0


def test_generate_is_deterministic_per_batch(engine):
    prompts = engine.synthetic_prompts(1, 8)
    a = engine.generate(prompts, 4)["tokens"]
    b = engine.generate(prompts, 4)["tokens"]
    assert torch.equal(a, b)


def test_generate_runs_no_kernel_on_cpu(engine):
    before = ops.launch_counts()
    engine.generate(engine.synthetic_prompts(1, 8), 3)
    assert ops.launch_counts() == before


def test_infer_payload_knobs(engine):
    out = engine.infer({"prompt_len": 8, "gen": 4, "batch": 2})
    assert out["arch"] == ARCH and out["batch"] == 2 and out["prompt_len"] == 8
    assert len(out["tokens"]) == 4
    assert out["decode_ms_per_token"] > 0
    assert len(ServeEngine.infer(engine, None)["tokens"]) == 8
    assert len(engine.infer({"gen": 0})["tokens"]) == 2  # gen = max(2, …)


def test_engine_attached_to_a_service_serves_invokes(engine):
    """A port engine behind the reference's workloads tier answers
    /v2/workloads/{name}/invoke with generated tokens."""
    from repro.api import Federation
    from repro.api.client import WorkloadClient

    fed = Federation(n_shards=1, tick_period=5.0)
    client = WorkloadClient.for_platform(fed, tenant="team-a")
    client.apply({"kind": "Service", "name": "lm", "tenant": "team-a",
                  "replicas": 1, "engine": "real", "arch": ARCH})
    fed.workloads.attach_engine("team-a", "lm", engine)
    for _ in range(60):
        fed.tick()
        if client.get("lm")["status"]["phase"] == "RUNNING":
            break
    else:
        pytest.fail("service never converged")
    out = client.invoke("lm", payload={"prompt_len": 8, "gen": 4})
    assert out["replica"] == "0"
    assert out["output"]["arch"] == ARCH
    assert len(out["output"]["tokens"]) == 4


def test_engine_attached_to_a_port_service_serves_invokes(engine):
    """The same through the port's own workloads tier: its Federation on
    the CPU and its WorkloadClient; a second replica takes every other
    invoke."""
    from repro_torch.api import Federation, WorkloadClient

    fed = Federation(n_shards=1, tick_period=5.0, device="cpu")
    client = WorkloadClient.for_platform(fed, tenant="team-a")
    service = {"kind": "Service", "name": "lm", "tenant": "team-a",
               "replicas": 1, "engine": "real", "arch": ARCH}
    client.apply(service)
    fed.workloads.attach_engine("team-a", "lm", engine)

    def ready(n):
        for _ in range(60):
            fed.tick()
            st = client.get("lm")["status"]
            if st["phase"] == "RUNNING" and len(st["ready_slots"]) == n:
                return
        pytest.fail(f"service never converged to {n} ready replicas")

    ready(1)
    out = client.invoke("lm", payload={"prompt_len": 8, "gen": 4})
    assert out["replica"] == "0"
    assert out["output"]["arch"] == ARCH
    assert len(out["output"]["tokens"]) == 4
    client.apply({**service, "replicas": 2})
    ready(2)
    slots = [client.invoke("lm", payload={"prompt_len": 8, "gen": 2})["replica"]
             for _ in range(4)]
    assert sorted(set(slots)) == ["0", "1"]
    assert all(a != b for a, b in zip(slots, slots[1:]))
