"""Training of the decoder-only attention archs of the port (llama3-8b,
deepseek-coder-33b, qwen2.5-3b with QKV bias, chameleon-34b with QK-norm,
granite-moe-3b-a800m and qwen3-moe-235b-a22b with the MoE FFN) against the
JAX package, at their tiny configs, on the CPU: the loss and every
gradient leaf, train steps, and an MoE batch that drops rows at capacity.

The JAX package materializes the params; the biases and head-norm scales
are redrawn nonzero (``test_torch_archs._redraw``) so that their gradients
carry values, and the attention projections are rescaled to their true
fan-in (``test_torch_recurrent_train._true_fan_in``). On the default init
the fp32 ``embed`` gradient misses 1e-5 by up to 1.4e-4 (llama3, granite)
while every other leaf agrees: attention there is nearly one-hot and the
loss ill-conditioned (ROADMAP C.9), and at the true fan-in the gap closes.
``repro_torch.convert`` loads the same arrays into the port; on the CPU its
flash attention is the plain version, which carries autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_archs import _cfgs, _redraw
from test_torch_recurrent_train import _np_tree, _port_loss_grads, _true_fan_in

import chip_smoke
from repro.models import steps as jsteps
from repro.nn import moe as jmoe
from repro.optim import adamw as jadamw
from repro.utils.trees import tree_map_with_path as jtree_map

from repro_torch.configs import get_tiny_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import steps
from repro_torch.nn import moe
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths

ARCHS = ["llama3-8b", "deepseek-coder-33b", "qwen2.5-3b", "chameleon-34b",
         "granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
GRANITE = "granite-moe-3b-a800m"
LAYOUTS = {"list": {}, "stacked": {"scan_layers": True}}
CASES = [(a, "list") for a in ARCHS] + [(GRANITE, "stacked")]
CASE_IDS = [f"{a}-{layout}" for a, layout in CASES]


def _j_params(jcfg, seed):
    """The reference's init, its biases and head-norm scales redrawn
    nonzero, its attention projections at their true fan-in."""
    jparams = jsteps.init_params(jcfg, jax.random.key(seed))
    flat = _redraw(_np_tree(jparams), seed + 100)
    return _true_fan_in(jtree_map(lambda p, _: jnp.asarray(flat[p]), jparams), jcfg)


def _batch(seed, b=2, s=32, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _j_loss_grads(jcfg, jparams, batch):
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in parts.items()}, _np_tree(grads)


_JAX_GRADS = {}


def _jax_case(arch, layout):
    """The reference's fp32 loss and gradients of one (arch, layout) on its
    params and batch, computed once for the module."""
    if (arch, layout) not in _JAX_GRADS:
        jcfg, _ = _cfgs(arch, dtype="float32", **LAYOUTS[layout])
        jparams = _j_params(jcfg, 0)
        batch = _batch(6)
        _JAX_GRADS[arch, layout] = (_np_tree(jparams), batch,
                                    *_j_loss_grads(jcfg, jparams, batch))
    return _JAX_GRADS[arch, layout]


# --------------------------------------------------------------------------
# the loss and every gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch,layout", CASES, ids=CASE_IDS)
def test_loss_and_grads_match_jax(arch, layout, remat):
    """fp32: the loss, ce and aux within 1e-6 and every gradient leaf within
    atol = rtol = 1e-5 of jax.value_and_grad of the reference's loss_fn,
    the new leaves among them: the QKV biases (through ``addmm``'s
    backward), the head-norm scales (taken before RoPE), an untied
    unembedding, and the MoE's router (through ``topk``'s backward and the
    aux) and experts (through the dispatch and combine gathers)."""
    flat, batch, jloss, jparts, jgrads = _jax_case(arch, layout)
    _, cfg = _cfgs(arch, dtype="float32", remat=remat, **LAYOUTS[layout])
    loss, parts, grads = _port_loss_grads(cfg, flat, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(parts["ce"].item(), jparts["ce"], rtol=1e-6)
    np.testing.assert_allclose(parts["aux"].item(), jparts["aux"], rtol=1e-6, atol=1e-7)
    assert (parts["aux"].item() > 0) == cfg.is_moe
    assert set(grads) == set(jgrads)
    names = {p.rsplit("/", 1)[-1] for p in grads} | {"/".join(p.split("/")[-2:]) for p in grads}
    assert ("bq" in names) == cfg.qkv_bias and ("q_norm/scale" in names) == cfg.qk_norm
    assert ("unembed" in names) == (not cfg.tie_embeddings)
    assert ("moe/router" in names) == cfg.is_moe
    for path, g in grads.items():
        assert g.dtype == torch.float32
        assert float(np.abs(jgrads[path]).max()) > 0, path  # every leaf carries a gradient
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-5,
                                   err_msg=path)


def test_remat_does_not_change_gradients():
    """remat none, full and dots give bit-identical loss and gradients in
    the port for granite stacked in bf16 (the training dtype): the
    recompute repeats the same arithmetic, routing and capacity included."""
    jcfg, _ = _cfgs(GRANITE, **LAYOUTS["stacked"])
    flat = _np_tree(_j_params(jcfg, 1))
    batch = _batch(7)
    results = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _cfgs(GRANITE, remat=remat, **LAYOUTS["stacked"])
        results[remat] = _port_loss_grads(cfg, flat, batch)
    loss0, parts0, g0 = results["none"]
    for remat in ("full", "dots"):
        loss, parts, g = results[remat]
        assert torch.equal(loss, loss0) and torch.equal(parts["aux"], parts0["aux"]), remat
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)


# --------------------------------------------------------------------------
# whole train steps against the reference's jitted step
# --------------------------------------------------------------------------

N_STEPS = 3
# AdamW's eps is 1e-6 here, the default 1e-8 in the train CLI. Adam's step
# lr·m/(sqrt(v) + eps) is lr-sized whatever the gradient's size, so with the
# default eps a gradient element within fp32 rounding of zero turns the two
# packages' rounding into an lr-sized difference of the param (chameleon's
# embed has one at 2.7e-9 against 1.6e-9: the params end 1.4e-4 apart). At
# eps 1e-6 such an element moves by lr·|g|/eps, and the params are held at
# 1e-5 everywhere. Both packages get the same config.
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20, eps=1e-6)


def _pinned_train_step(jcfg, opt_cfg):
    """The reference's train step with its routing pinned: fn(state, batch,
    pins) where ``pins`` holds each MoE layer's choices (T, k). Each layer's
    router takes its experts from ``pins`` and weighs them with its own
    probabilities there, renormalized over the k, and its aux counts the
    pinned top choice: ``router_topk`` with the selection given (its
    weights are the probabilities gathered at the top-k indices too)."""
    step = jsteps.make_train_step(jcfg, opt_cfg)

    def pinned(state, batch, pins):
        layers = iter(pins)

        def router_topk(p_router, x, top_k):
            idx = next(layers)  # traced once a layer, in layer order
            probs = jax.nn.softmax(jnp.einsum("td,de->te", x.astype(jnp.float32), p_router),
                                   axis=-1)
            w = jnp.take_along_axis(probs, idx, axis=-1)
            w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
            n_experts = probs.shape[-1]
            hard = jax.nn.one_hot(idx[:, 0], n_experts, dtype=jnp.float32)
            return w, idx, n_experts * jnp.mean(jnp.mean(hard, axis=0) * jnp.mean(probs, axis=0))

        orig, jmoe.router_topk = jmoe.router_topk, router_topk
        try:
            return step(state, batch)
        finally:
            jmoe.router_topk = orig

    return pinned


def _run_both(arch, dtype, pin_routing=False):
    """N_STEPS of the reference's jitted step and the port's step from the
    same state and batches. With ``pin_routing``, each reference step takes
    the routing choices that the port's step (which runs first, unchanged)
    made on the same batch, layer by layer."""
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    opt = OPT
    jparams = _j_params(jcfg, 2)
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    state = train_state_from_numpy(_np_tree(jstate), cfg, "cpu")
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**opt))
    if pin_routing:
        jstep = jax.jit(_pinned_train_step(jcfg, jadamw.AdamWConfig(**opt)))
        routers = [lp["moe"]["router"] for lp in state.params["blocks"]["layers"]]
    else:
        jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2, seed=3))
    jm, tm = [], []
    for i in range(N_STEPS):
        batch = data.batch_at(i)
        chosen = {}  # the port's choices by router storage (updated in place)
        router_topk = moe.router_topk

        def recording(p_router, x, top_k):
            w, idx, aux = router_topk(p_router, x, top_k)
            chosen[p_router.data_ptr()] = idx
            return w, idx, aux

        moe.router_topk = recording
        try:
            state, met = step(state, batch)
        finally:
            moe.router_topk = router_topk
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if pin_routing:
            pins = [jnp.asarray(chosen[r.data_ptr()].numpy(), jnp.int32) for r in routers]
            jstate, jmet = jstep(jstate, jbatch, pins)
        else:
            jstate, jmet = jstep(jstate, jbatch)
        jm.append({k: float(v) for k, v in jmet.items()})
        tm.append({k: float(v) for k, v in met.items()})
    return jstate, state, jm, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_fp32_match_jax(arch):
    """fp32: each step's loss, ce, aux and grad norm within 1e-5 and the
    final params, master, m and v within 1e-5 of the reference's jitted
    make_train_step (ce + 0.01 aux), each package routing on its own."""
    jstate, state, jm, tm = _run_both(arch, "float32")
    for a, b in zip(tm, jm):
        for key in ("loss", "ce", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(a["aux"], b["aux"], rtol=1e-5, atol=1e-7)
    assert int(state.step) == N_STEPS
    want = _np_tree(jstate)
    for path, got in tree_flatten_with_paths(state):
        np.testing.assert_allclose(got.detach().float().numpy(), want[path].astype(np.float32),
                                   atol=1e-5, rtol=1e-5, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_bf16_match_jax(arch):
    """bf16 (the training dtype): each step's loss and grad norm within 2e-2
    and the final params within 2e-2, as tests/test_torch_train.py holds
    smollm: the two round at different points inside attention (ROADMAP
    C.8), and bf16 gradients carry that into every Adam step. An MoE arch's
    reference step takes the port's routing choices (``_pinned_train_step``):
    in bf16 those rounding differences flip choices near ties, and a flipped
    token's FFN output changes whole (ROADMAP C.13; qwen3-moe's grad norm
    moves 2-4% on its own routing). Both packages' own top-k are held in
    fp32, above, and in tests/test_torch_moe.py."""
    jstate, state, jm, tm = _run_both(arch, "bfloat16", pin_routing=get_tiny_config(arch).is_moe)
    for a, b in zip(tm, jm):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-2, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    want = _np_tree(jstate)
    for path, t in tree_flatten_with_paths(state.params):
        np.testing.assert_allclose(t.float().numpy(), want[f"params/{path}"].astype(np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=path)


# --------------------------------------------------------------------------
# an MoE batch that drops rows at capacity
# --------------------------------------------------------------------------

def test_moe_grads_with_rows_dropped_at_capacity_match_jax():
    """granite tiny in fp32 on a batch whose first row repeats one token: its
    32 tokens route alike, so the experts they pick overflow their capacity
    (32 rows at T=64, k=2, E=5) and rows drop, in the reference as in the
    port (a stable sort over the flattened stream decides which). The loss
    within 1e-6 and every gradient leaf within 1e-5 of the reference's, the
    router's and the experts' among them. Near-ties of the port's router
    (k-th and (k+1)-th probabilities within 1e-6) are reported: there fp32
    sums in another order could pick another expert (ROADMAP C.13)."""
    jcfg, cfg = _cfgs(GRANITE, dtype="float32")
    jparams = _j_params(jcfg, 4)
    batch = _batch(8)
    batch["tokens"][0] = 17
    jloss, jparts, jgrads = _j_loss_grads(jcfg, jparams, batch)

    drops, ties = [], 0
    dispatch, router_topk = moe._dispatch_indices, moe.router_topk

    def counting_dispatch(idx, n_experts, cap, *local_experts):
        src, sizes = dispatch(idx, n_experts, cap, *local_experts)
        drops.append(idx.numel() - int(sizes.sum()))
        return src, sizes

    def tie_report(p_router, x, top_k):
        nonlocal ties
        probs = torch.softmax(x.float() @ p_router, dim=-1).sort(dim=-1, descending=True).values
        ties += int((probs[:, top_k - 1] - probs[:, top_k] < 1e-6).sum())
        return router_topk(p_router, x, top_k)

    moe._dispatch_indices, moe.router_topk = counting_dispatch, tie_report
    try:
        loss, parts, grads = _port_loss_grads(cfg, _np_tree(jparams), batch)
    finally:
        moe._dispatch_indices, moe.router_topk = dispatch, router_topk
    print(f"granite tiny, skewed batch: rows dropped at capacity per layer {drops}; "
          f"router near-ties (gap < 1e-6): {ties}")
    assert drops and drops[0] > 0
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(parts["aux"].item(), jparts["aux"], rtol=1e-6)
    assert set(grads) == set(jgrads)
    assert {p.split("/")[-1] for p in grads} >= {"router", "up", "gate", "down"}
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-5,
                                   err_msg=path)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card_step(arch, dtype, force=None, remat="full"):
    """One train step of a tiny config on the card from the weights
    ``chip_smoke.py`` trains (``fresh_states``: seeded, the attention
    projections at their true fan-in, QKV biases drawn nonzero): (metrics
    as floats, the new state, the launches it made). On the default init
    two correct bf16 roundings of attention part by 3% in qwen2.5's tiny
    grad norm (ROADMAP C.9; the plain path against it with P rounded as the
    reference model's chunked twin rounds it, on the CPU), at true fan-in
    by 1.6e-4."""
    from repro_torch.launch.train import deterministic

    deterministic(torch.device("cuda"))
    cfg = get_tiny_config(arch).replace(dtype=dtype, remat=remat)
    state = chip_smoke.fresh_states(cfg, "cuda")[1]()
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=1)).batch_at(0)
    ops.reset_launch_counts()
    state, met = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT), force=force)(state, batch)
    torch.cuda.synchronize()
    return {k: float(v) for k, v in met.items()}, state, ops.launch_counts()


@pytest.mark.gpu
def test_granite_tiny_step_on_card_is_deterministic():
    """On the card, under deterministic algorithms (``launch.train.
    deterministic``, which raises on an op with no deterministic kernel): a
    granite tiny bf16 step, run twice from the same seed, ends on the same
    state bit for bit (the MoE's topk, dispatch and combine backwards among
    its ops), through the flash kernels (2 forward and 1 backward launch a
    layer under remat full)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels train there "
                    "(python3 chip_smoke.py trains granite at full width)")
    a_met, a, launches = _card_step(GRANITE, "bfloat16")
    b_met, b, _ = _card_step(GRANITE, "bfloat16")
    n = get_tiny_config(GRANITE).n_layers
    assert launches["flash_attention"] == 2 * n and launches["flash_attention_bwd"] == n
    assert a_met == b_met and np.isfinite(a_met["loss"]) and a_met["aux"] > 0
    for (path, x), (_, y) in zip(tree_flatten_with_paths(a), tree_flatten_with_paths(b)):
        assert torch.equal(x, y), path


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 5e-5)])
def test_qwen25_tiny_step_on_card_matches_plain(dtype, tol):
    """On the card: a qwen2.5 tiny step (QKV bias) through the flash kernels
    against the same step on the plain versions (``force="ref"``): loss and
    grad norm within 2e-2 in bf16 (the forward kernel rounds P to bf16) and
    5e-5 in fp32 (the fp32 routes: sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels train there "
                    "(python3 chip_smoke.py trains qwen2.5-3b at full width)")
    got, _, launches = _card_step("qwen2.5-3b", dtype)
    want, _, plain_launches = _card_step("qwen2.5-3b", dtype, force="ref")
    assert launches["flash_attention_bwd"] == get_tiny_config("qwen2.5-3b").n_layers
    assert plain_launches["flash_attention"] == plain_launches["flash_attention_bwd"] == 0
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= tol * abs(want[key]), (key, got[key], want[key])
