"""The decoder-only attention archs of the port (llama3-8b,
deepseek-coder-33b, qwen2.5-3b with QKV bias, chameleon-34b with QK-norm,
granite-moe-3b-a800m and qwen3-moe-235b-a22b with the MoE FFN) against the
JAX package, at their tiny configs, on the CPU.

The JAX package materializes the params; the biases (zeros at init) and
the head-norm scales (ones at init) are then redrawn nonzero from a seeded
numpy generator, so that a bias added in the wrong place or a scale left
out shows; ``repro_torch.convert`` loads the same arrays into the port.
fp32: prefill logits and KV caches within 1e-4, greedy tokens identical
over 6 decode steps; bf16: last logits within 5e-2 (the port keeps q·scale
and the softmax probabilities in fp32 inside attention where the
reference's chunked twin rounds them to bf16).
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
from repro.nn import params as jprm
from repro.utils.trees import path_str
from repro.utils.trees import tree_flatten_with_paths as jflatten
from repro.utils.trees import tree_map_with_path as jtree_map

from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeEngine, _install_prefill
from repro_torch.models import lm, steps
from repro_torch.nn import attention
from repro_torch.utils.trees import tree_flatten_with_paths

ARCHS = ["llama3-8b", "deepseek-coder-33b", "qwen2.5-3b", "chameleon-34b",
         "granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
GRANITE = "granite-moe-3b-a800m"
LAYOUTS = {"list": {}, "stacked": {"scan_layers": True}}
# every arch in its tiny config's list layout, and granite stacked too
SERVE_CASES = [(a, "list") for a in ARCHS] + [(GRANITE, "stacked")]
N_DECODE = 6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _cfgs(arch, **kw):
    return jget_tiny(arch).replace(**kw), get_tiny_config(arch).replace(**kw)


def _redraw(flat: dict, seed: int) -> dict:
    """The flat params with the QKV biases drawn N(0, 1) and the head-norm
    scales 1 + N(0, 0.3^2), each in its leaf's dtype."""
    rng = _rng(seed)
    out = dict(flat)
    for path, a in flat.items():
        if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            out[path] = rng.standard_normal(a.shape).astype(a.dtype)
        elif path.endswith(("q_norm/scale", "k_norm/scale")):
            out[path] = (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    return out


def _params(jcfg, cfg, seed=0):
    """(JAX params, port params): the reference's init, biases and scales
    redrawn, the same arrays in both."""
    jparams = jsteps.init_params(jcfg, jax.random.key(seed))
    flat = _redraw({p: np.asarray(x) for p, x in jflatten(jparams)}, seed + 100)
    jparams = jtree_map(lambda p, _: jnp.asarray(flat[p]), jparams)
    return jparams, params_from_numpy(flat, cfg, "cpu")


def _jax_serve(jcfg, jparams, prompts, n_decode):
    jp = jnp.asarray(prompts, jnp.int32)
    logits, _, _ = jlm.lm_apply(jparams, jp, jcfg, mode="prefill")
    tok, pf_states, _ = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, {"tokens": jp})
    b, s = prompts.shape
    states = j_install_prefill(jsteps.decode_state(jcfg, b, s + n_decode + 1), pf_states,
                               jcfg, s)
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    toks = [np.asarray(tok)]
    for i in range(n_decode):
        tok, states = decode(jparams, tok, states, jnp.int32(s + i))
        toks.append(np.asarray(tok))
    return np.asarray(logits), pf_states, np.concatenate(toks, axis=1)


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
    return logits, pf_states, torch.cat(toks, dim=1).numpy()


def _caches(states):
    """[(k, v)] per layer of either layout (one stacked cache or a list), as
    numpy fp32."""
    states = states if isinstance(states, list) else [states]
    return [(np.asarray(c.k, np.float32), np.asarray(c.v, np.float32)) for c in states]


# --------------------------------------------------------------------------
# configs and trees
# --------------------------------------------------------------------------

def test_arch_ids_hold_the_eight_ported_archs():
    """The eight archs of the serving and training slices, xlstm-125m and
    whisper-tiny since: all ten of the reference's, in its order."""
    from repro.configs import ARCH_IDS as JARCH_IDS

    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10 and set(ARCHS) <= set(ARCH_IDS)
    assert {"smollm-360m", "recurrentgemma-2b", "xlstm-125m", "whisper-tiny"} <= set(ARCH_IDS)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_by_field(arch, tiny):
    jcfg = jget_tiny(arch) if tiny else jget_config(arch)
    cfg = get_tiny_config(arch) if tiny else get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.hd == jcfg.hd and cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_def_tree_matches_jax(arch):
    """The full config's stacked def-tree: paths, shapes, inits, scales and
    dtypes, the new leaves among them (the biases, the head-norm scales in
    fp32, the fp32 router, 4-D stacked experts)."""
    jleaves = jax.tree_util.tree_flatten_with_path(
        jsteps.model_defs(jget_config(arch)),
        is_leaf=lambda x: isinstance(x, jprm.ParamDef))[0]
    want = {path_str(p): (tuple(d.shape), d.init, d.scale, d.dtype) for p, d in jleaves}
    got = {p: (tuple(d.shape), d.init, d.scale, d.dtype)
           for p, d in tree_flatten_with_paths(steps.model_defs(get_config(arch)))}
    assert got == want
    cfg = get_config(arch)
    if cfg.is_moe:
        assert got["blocks/scan/moe/router"][0] == (cfg.n_layers, cfg.d_model, cfg.n_experts)
        assert got["blocks/scan/moe/router"][3] == "float32"
        assert got["blocks/scan/moe/down"][0] == (cfg.n_layers, cfg.n_experts, cfg.moe_d_ff,
                                                  cfg.d_model)
    if cfg.qkv_bias:
        assert got["blocks/scan/attn/bk"][:2] == ((cfg.n_layers, cfg.n_kv_heads, cfg.hd), "zeros")
    if cfg.qk_norm:
        assert got["blocks/scan/attn/q_norm/scale"] == ((cfg.n_layers, cfg.hd), "ones", None,
                                                        "float32")


@pytest.mark.parametrize("arch,layout", SERVE_CASES)
def test_params_from_numpy_loads_the_new_leaves(arch, layout):
    jcfg, cfg = _cfgs(arch, **LAYOUTS[layout])
    flat = {p: np.asarray(x) for p, x in jflatten(jsteps.init_params(jcfg, jax.random.key(0)))}
    params = params_from_numpy(flat, cfg, "cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_flatten_with_paths(params)}
    own = steps.init_params(cfg, seed=0)
    assert got == {p: (tuple(t.shape), t.dtype) for p, t in tree_flatten_with_paths(own)}
    assert set(got) == set(flat)
    pre = "blocks/scan/" if layout == "stacked" else "blocks/layers/1/"
    lead = (cfg.n_layers,) if layout == "stacked" else ()
    if cfg.is_moe:
        assert got[pre + "moe/router"] == (lead + (cfg.d_model, cfg.n_experts), torch.float32)
        assert got[pre + "moe/up"] == (lead + (cfg.n_experts, cfg.d_model, cfg.moe_d_ff),
                                       torch.bfloat16)
        assert pre + "mlp/up" not in got
    if cfg.qk_norm:
        assert got[pre + "attn/k_norm/scale"] == (lead + (cfg.hd,), torch.float32)
    if cfg.qkv_bias:
        assert got[pre + "attn/bq"] == (lead + (cfg.n_heads, cfg.hd), torch.bfloat16)
    for path in [p for p in flat if p.endswith(("bq", "q_norm/scale", "router"))]:
        with pytest.raises(ValueError, match="missing"):
            params_from_numpy({p: a for p, a in flat.items() if p != path}, cfg, "cpu")


# --------------------------------------------------------------------------
# the projections: QKV bias and QK-norm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qkv_bias,qk_norm", [(True, False), (False, True), (True, True)])
def test_project_qkv_matches_jax(qkv_bias, qk_norm, dtype):
    """The product, the bias, one cast to x's dtype, the head norm, RoPE:
    within 1e-5 in fp32, 2e-2 in bf16."""
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-5) if dtype == "float32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    defs = jattn.def_gqa(64, 4, 2, 16, qkv_bias, qk_norm)
    flat = _redraw({p: np.asarray(x) for p, x in
                    jflatten(jprm.materialize(jax.random.key(2), defs, jdt))}, 5)
    jp = {}
    for path, a in flat.items():  # rebuild the nested dict of both packages
        node = jp
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = a
    jp_j = jax.tree_util.tree_map(jnp.asarray, jp)
    jp_t = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            torch.float32 if a.dtype == np.float32 else tdt), jp)
    assert set(jp) >= ({"bq", "bk", "bv"} if qkv_bias else set()) | (
        {"q_norm", "k_norm"} if qk_norm else set())
    x = _rng(1).standard_normal((2, 12, 64), np.float32)
    pos = np.broadcast_to(np.arange(100, 112), (2, 12)).copy()
    jout = jattn._project_qkv(jp_j, jnp.asarray(x, jdt), jnp.asarray(pos), 1e6)
    out = attention._project_qkv(jp_t, torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 1e6)
    for o, jo in zip(out, jout):
        assert o.dtype == tdt
        np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                                   atol=tol, rtol=tol)


def test_bf16_bias_is_added_before_the_one_rounding():
    """In bf16 the bias joins the fp32-accumulated product and the sum is
    rounded once, as the reference rounds it: the port's projection equals
    that on all but a few elements (sums in another order), where rounding
    the product first and then the sum would differ on many."""
    rng = _rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64), np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((64, 4, 16), np.float32)).bfloat16()
    b = torch.from_numpy(3 * rng.standard_normal((4, 16), np.float32)).bfloat16()
    exact = torch.einsum("bsd,dhk->bhsk", x.float(), w.float()) + b.float()[None, :, None]
    once = exact.bfloat16()
    twice = (torch.einsum("bsd,dhk->bhsk", x.float(), w.float()).bfloat16().float()
             + b.float()[None, :, None]).bfloat16()
    got = attention._project(x, w, b)
    assert got.dtype == torch.bfloat16 and got.shape == once.shape
    same_once = (got == once).float().mean().item()
    same_twice = (got == twice).float().mean().item()
    assert same_once >= 0.999, same_once
    assert same_twice < 0.95, same_twice


# --------------------------------------------------------------------------
# each arch end to end
# --------------------------------------------------------------------------

def _tie_report(cfg, params, prompts):
    """Tokens whose router's k-th and (k+1)-th probabilities lie within
    1e-6, over every MoE layer of the port's prefill (reported: there fp32
    sums in another order may pick another expert)."""
    if not cfg.is_moe:
        return 0
    from repro_torch.nn import moe
    ties = 0
    orig = moe.router_topk

    def spy(p_router, x, top_k):
        nonlocal ties
        probs = torch.softmax(x.float() @ p_router, dim=-1).sort(dim=-1, descending=True).values
        ties += int((probs[:, top_k - 1] - probs[:, top_k] < 1e-6).sum())
        return orig(p_router, x, top_k)

    moe.router_topk = spy
    try:
        lm.lm_apply(params, torch.from_numpy(prompts).long(), cfg, mode="prefill")
    finally:
        moe.router_topk = orig
    return ties


@pytest.mark.parametrize("arch,layout", SERVE_CASES)
def test_fp32_prefill_and_greedy_decode_match_jax(arch, layout):
    """fp32: prefill logits and KV caches within 1e-4, then greedy tokens
    over 6 decode steps identical to the reference serving loop."""
    jcfg, cfg = _cfgs(arch, dtype="float32", **LAYOUTS[layout])
    jparams, params = _params(jcfg, cfg)
    prompts = _rng(7).integers(0, cfg.vocab_size, (2, 12))
    print(f"{arch} {layout}: router near-ties in the prefill: "
          f"{_tie_report(cfg, params, prompts)}")
    jlogits, jstates, jtoks = _jax_serve(jcfg, jparams, prompts, N_DECODE)
    logits, states, toks = _port_serve(cfg, params, prompts, N_DECODE)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
    for (k, v), (jk, jv) in zip(_caches(states), _caches(jstates), strict=True):
        np.testing.assert_allclose(k, jk, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(v, jv, atol=1e-4, rtol=1e-4)
    assert toks.shape == (2, N_DECODE + 1)
    np.testing.assert_array_equal(toks, jtoks)


@pytest.mark.parametrize("arch,layout", SERVE_CASES)
def test_bf16_prefill_logits_match_jax(arch, layout):
    jcfg, cfg = _cfgs(arch, **LAYOUTS[layout])
    jparams, params = _params(jcfg, cfg)
    prompts = _rng(8).integers(0, cfg.vocab_size, (2, 16))
    _, _, jlast = jax.jit(jsteps.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
    _, _, last = steps.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(prompts).long()})
    assert last.dtype == torch.float32
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=5e-2, rtol=5e-2)


def test_moe_train_aux_is_the_sum_of_the_layers():
    """Train mode returns the MoE blocks' aux summed over the layers (the
    reference's lm_apply aux), within 1e-6 in fp32."""
    jcfg, cfg = _cfgs(GRANITE, dtype="float32")
    jparams, params = _params(jcfg, cfg)
    tokens = _rng(9).integers(0, cfg.vocab_size, (2, 16))
    jlogits, _, jaux = jlm.lm_apply(jparams, jnp.asarray(tokens, jnp.int32), jcfg, mode="train")
    logits, aux = lm.lm_apply(params, torch.from_numpy(tokens).long(), cfg, mode="train")
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    assert float(aux) > 0


# --------------------------------------------------------------------------
# ServeEngine and the serving tier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_on_cpu_without_a_kernel(arch):
    engine = ServeEngine(arch, tiny=True, device="cpu")
    before = ops.launch_counts()
    out = engine.generate(engine.synthetic_prompts(2, 8), 4)
    assert ops.launch_counts() == before
    assert out["tokens"].shape == (2, 4)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < engine.cfg.vocab_size)).all())


def test_granite_engine_attached_to_a_service_serves_invokes():
    """A granite-moe port engine behind the reference's workloads tier
    answers /v2/workloads/{name}/invoke with generated tokens."""
    from repro.api import Federation
    from repro.api.client import WorkloadClient

    engine = ServeEngine(GRANITE, tiny=True, device="cpu")
    fed = Federation(n_shards=1, tick_period=5.0)
    client = WorkloadClient.for_platform(fed, tenant="team-a")
    client.apply({"kind": "Service", "name": "moe", "tenant": "team-a",
                  "replicas": 1, "engine": "real", "arch": GRANITE})
    fed.workloads.attach_engine("team-a", "moe", engine)
    for _ in range(60):
        fed.tick()
        if client.get("moe")["status"]["phase"] == "RUNNING":
            break
    else:
        pytest.fail("service never converged")
    out = client.invoke("moe", payload={"prompt_len": 8, "gen": 4, "batch": 2})
    assert out["output"]["arch"] == GRANITE
    assert len(out["output"]["tokens"]) == 4


@pytest.mark.gpu
def test_granite_tiny_prefill_on_card_matches_plain_and_repeats_bit_for_bit():
    """On the card: a tiny granite prefill through the flash kernel
    (one launch a layer) against the plain path (fp32 within 1e-3, bf16
    within 0.1), and two bf16 prefills of the same prompts bit-equal (the
    MoE dispatch and combine use no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel is built and run there")
    cfg = get_tiny_config(GRANITE)
    gen = torch.Generator(device="cpu").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).cuda()
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 0.1)):
        run_cfg = cfg.replace(dtype=dtype)
        params = steps.init_params(run_cfg, 0, "cuda")
        with torch.inference_mode():
            before = ops.launch_counts()["flash_attention"]
            got = [steps.make_prefill_step(run_cfg)(params, {"tokens": tokens})
                   for _ in range(2)]
            launches = ops.launch_counts()["flash_attention"] - before
            want = steps.make_prefill_step(run_cfg, force="ref")(params, {"tokens": tokens})
        torch.cuda.synchronize()
        assert launches == 2 * cfg.n_layers
        (_, states_a, last_a), (_, states_b, last_b) = got
        assert torch.equal(last_a, last_b), dtype
        assert all(torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
                   for a, b in zip(states_a, states_b)), dtype
        assert torch.isfinite(last_a).all()
        assert (last_a - want[2]).abs().max().item() <= tol, dtype
