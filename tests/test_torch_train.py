"""The port's training slice (repro_torch) against the JAX package on the
CPU: the attention backward's plain version, the forward's logsumexp, the
loss, AdamW, the loss's gradients through the whole tiny model, a few full
train steps, remat, and the synthetic data stream.

The JAX package materializes the params and ``repro_torch.convert`` loads
them; inputs are made with numpy from fixed seeds. On the CPU the port's
flash attention is its plain version, which carries autograd. Tolerances
are stated where they are used: fp32 comparisons sit at 1e-5 or tighter;
bf16 ones at 2e-2, the bf16 tolerance of tests/test_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro.utils.trees import tree_flatten_with_paths as jflatten
from repro.utils.trees import tree_map_with_path as jtree_map_with_path

from repro_torch.configs import get_tiny_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops, ref
from repro_torch.models import lm, steps
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

ARCH = "smollm-360m"
LAYOUTS = {"list": {}, "stacked": {"scan_layers": True}}


def _np_tree(jtree):
    return {p: np.asarray(x) for p, x in jflatten(jtree)}


def _flat_np(tree):
    return {p: t.detach().float().numpy() for p, t in tree_flatten_with_paths(tree)}


def _cfgs(**kw):
    return jget_tiny(ARCH).replace(**kw), get_tiny_config(ARCH).replace(**kw)


def _true_fan_in(jparams, cfg):
    """The reference's params with the attention projections rescaled to
    their true fan-in (chip_smoke.true_fan_in): the default init divides by
    the heads axis, which makes attention nearly one-hot and the loss so
    ill-conditioned that fp32 rounding differences grow to 3e-5 of a
    gradient; at the true fan-in both packages agree to fp32 rounding."""
    d, hd = cfg.d_model, cfg.hd
    rescale = {"attn/wq": (cfg.n_heads / d) ** 0.5, "attn/wk": (cfg.n_kv_heads / d) ** 0.5,
               "attn/wv": (cfg.n_kv_heads / d) ** 0.5, "attn/wo": (hd / (cfg.n_heads * hd)) ** 0.5}
    return jtree_map_with_path(
        lambda path, x: x * rescale.get("/".join(path.split("/")[-2:]), 1.0), jparams)


def _j_params(jcfg, seed):
    return _true_fan_in(jsteps.init_params(jcfg, jax.random.key(seed)), jcfg)


# --------------------------------------------------------------------------
# the attention backward's plain version, and the forward's logsumexp
# --------------------------------------------------------------------------

# (B, H, KV, Sq, Skv, D, causal, window, q_offset)
BWD_CASES = [
    (2, 4, 2, 48, 48, 16, True, 0, 0),     # GQA causal, head_dim 16
    (1, 4, 4, 40, 40, 32, True, 0, 0),     # MHA
    (2, 4, 1, 64, 64, 64, True, 16, 0),    # MQA, local window
    (1, 2, 2, 32, 32, 128, False, 0, 0),   # bidirectional, head_dim 128
    (1, 6, 2, 20, 70, 32, True, 24, 50),   # Sq != Skv, q_offset, window
    (2, 15, 5, 33, 33, 64, True, 0, 0),    # smollm's 15/5 grouping, ragged
]
BWD_IDS = [f"B{c[0]}H{c[1]}KV{c[2]}Sq{c[3]}Skv{c[4]}D{c[5]}"
           f"{'c' if c[6] else 'b'}w{c[7]}o{c[8]}" for c in BWD_CASES]


def _bwd_inputs(b, h, kv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, kv, skv, d), np.float32),
            rng.standard_normal((b, kv, skv, d), np.float32),
            rng.standard_normal((b, h, sq, d), np.float32))


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,q_offset", BWD_CASES, ids=BWD_IDS)
def test_bwd_ref_matches_autograd_and_jax_grad(b, h, kv, sq, skv, d, causal, window,
                                               q_offset):
    """The explicit backward formulas equal torch autograd through the plain
    forward and jax.grad through the reference's, within 1e-5 in fp32."""
    q_np, k_np, v_np, do_np = _bwd_inputs(b, h, kv, sq, skv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q_np, k_np, v_np))
    do = torch.from_numpy(do_np)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                                      do, lse.detach(), **kw)
    jgrads = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda *a: jref.flash_attention_ref(*a, **kw), q, k, v)[1](do))(
            *(jnp.asarray(a) for a in (q_np, k_np, v_np, do_np)))
    for g, w, jg in zip(got, want, jgrads):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,q_offset", BWD_CASES, ids=BWD_IDS)
def test_lse_matches_jax_logsumexp_of_reference_scores(b, h, kv, sq, skv, d, causal,
                                                       window, q_offset):
    """The plain forward's lse is jax.nn.logsumexp of the reference's masked
    scaled scores (1e-5 in fp32), and the output is unchanged by asking."""
    q_np, k_np, v_np, _ = _bwd_inputs(b, h, kv, sq, skv, d, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = (torch.from_numpy(a) for a in (q_np, k_np, v_np))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, ref.flash_attention_ref(q, k, v, **kw))

    @jax.jit
    def reference_lse(q, k):
        qg = q.reshape(b, kv, h // kv, sq, d) * (d ** -0.5)
        s = jnp.einsum("bkgsd,bkcd->bkgsc", qg, k)
        q_pos = q_offset + jnp.arange(sq)
        k_pos = jnp.arange(skv)
        if causal:
            s = jnp.where(q_pos[:, None] >= k_pos[None, :], s, -1e30)
        if window > 0:
            s = jnp.where(q_pos[:, None] - k_pos[None, :] < window, s, -1e30)
        return jax.nn.logsumexp(s, axis=-1).reshape(b, h, sq)

    want = reference_lse(jnp.asarray(q_np), jnp.asarray(k_np))
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_bwd_ref_bf16_inputs_give_bf16_grads_near_fp32():
    """bf16 inputs: the gradients come back in bf16, within 2e-2 of the
    fp32 backward on the same (bf16-rounded) values."""
    q_np, k_np, v_np, do_np = _bwd_inputs(1, 4, 2, 40, 40, 32, seed=2)
    qb, kb, vb, dob = (torch.from_numpy(a).to(torch.bfloat16) for a in (q_np, k_np, v_np, do_np))
    o, lse = ref.flash_attention_ref(qb, kb, vb, return_lse=True)
    got = ref.flash_attention_bwd_ref(qb, kb, vb, o, dob, lse)
    o32, lse32 = ref.flash_attention_ref(qb.float(), kb.float(), vb.float(), return_lse=True)
    want = ref.flash_attention_bwd_ref(qb.float(), kb.float(), vb.float(), o32, dob.float(), lse32)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=2e-2, rtol=2e-2)


def test_dispatcher_on_cpu_carries_autograd_and_counts_nothing():
    """On the CPU, with grad on, flash attention is the plain version (its
    gradients are autograd's) and launches no kernel."""
    q_np, k_np, v_np, do_np = _bwd_inputs(1, 4, 2, 24, 24, 16, seed=3)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q_np, k_np, v_np))
    before = ops.launch_counts()
    o = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(do_np))
    assert ops.launch_counts() == before
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_kernel_backward_on_cpu_raises():
    """FlashAttentionFn is the card's path: forced onto CPU tensors with grad
    on, the kernel's wrapper raises instead of falling back."""
    q, k, v = (torch.zeros((1, 2, 8, 16), requires_grad=True) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, force="kernel")


# --------------------------------------------------------------------------
# cross-entropy, AdamW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(z_loss, masked):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    if masked:
        labels[0, :4] = -1
        labels[2, -1] = -1
    got = lm.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=z_loss)
    want = jax.jit(jlm.cross_entropy, static_argnames="z_loss")(
        jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # every label masked: the mean over max(count, 1) is 0
    none = lm.cross_entropy(torch.from_numpy(logits), torch.full((3, 7), -1), z_loss=z_loss)
    assert none.item() == 0.0


def _opt_tree(rng, grad_scale):
    """Params (fp32 matrix and vector, a bf16 matrix, a stacked (L, d) norm
    scale), their grads in the params' dtypes, and a random AdamW state."""
    shapes = {"w": ((6, 5), np.float32), "b": ((5,), np.float32),
              "e": ((4, 6), "bf16"), "scan": {"norm": {"scale": ((3, 5), np.float32)}}}

    def build(fn):
        def go(node):
            if isinstance(node, dict):
                return {k: go(v) for k, v in node.items()}
            return fn(*node)
        return go(shapes)

    master = build(lambda s, dt: rng.standard_normal(s).astype(np.float32))
    grads = build(lambda s, dt: (grad_scale * rng.standard_normal(s)).astype(np.float32))
    m = build(lambda s, dt: (0.1 * rng.standard_normal(s)).astype(np.float32))
    v = build(lambda s, dt: (0.01 * rng.random(s)).astype(np.float32))
    dtypes = build(lambda s, dt: dt)
    return master, grads, m, v, dtypes


def _j_leaf(a, dt):
    return jnp.asarray(a).astype(jnp.bfloat16 if dt == "bf16" else jnp.float32)


def _t_leaf(a, dt):
    return torch.from_numpy(a).to(torch.bfloat16 if dt == "bf16" else torch.float32)


@pytest.mark.parametrize("step", [0, 4, 10, 55, 200])
@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_jax(step, clipped):
    """New params, m, v, master, grad norm and lr equal the reference's
    within 1e-6 (fp32 elementwise in the same order; the schedule's cos and
    the bias corrections' pow may differ in the last bit), over warmup,
    its end, the cosine and past total_steps, clipping on (grad norm far
    above clip_norm) and off, a bf16 param cast back from its master and a
    stacked (L, d) norm scale, which is decayed like any 2-D leaf."""
    rng = np.random.default_rng(5 + step)
    master, grads, m, v, dtypes = _opt_tree(rng, 10.0 if clipped else 0.01)
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=100)
    jmap = lambda fn, *ts: jax.tree.map(fn, *ts)  # noqa: E731
    jstate = jadamw.OptState(*(jmap(jnp.asarray, t) for t in (m, v, master)))
    jgrads = jmap(_j_leaf, grads, dtypes)
    jp, jst, jm = jax.jit(jadamw.update, static_argnums=(0, 4))(
        jadamw.AdamWConfig(**cfg), jgrads, jstate, jnp.int32(step), jnp.float32)

    def tmap(fn, *ts):
        flats = [dict(tree_flatten_with_paths(t)) for t in ts]
        return tree_unflatten({p: fn(*(f[p] for f in flats)) for p in flats[0]})

    state = adamw.OptState(*(tmap(torch.from_numpy, t) for t in (m, v, master)))
    tgrads = tmap(_t_leaf, grads, dtypes)
    tp, tst, tm = adamw.update(adamw.AdamWConfig(**cfg), tgrads, state,
                               torch.tensor(step, dtype=torch.int32))
    assert (float(jm["grad_norm"]) > 1.0) == clipped
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
    assert tm["lr"].dtype == torch.float32
    for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v), (tst.master, jst.master)):
        gflat, wflat = dict(tree_flatten_with_paths(got)), dict(jflatten(want))
        assert set(gflat) == set(wflat)
        for path, g in gflat.items():
            w = np.asarray(wflat[path])
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
            np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                       atol=1e-6, rtol=1e-6, err_msg=path)
    # the stacked norm scale is decayed as a 2-D leaf (lr is 0 at step 0)
    if step:
        decayed = adamw.update(adamw.AdamWConfig(**cfg, decay_vectors=True), tgrads, state,
                               torch.tensor(step, dtype=torch.int32))[1].master
        assert torch.equal(tst.master["scan"]["norm"]["scale"],
                           decayed["scan"]["norm"]["scale"])
        assert not torch.equal(tst.master["b"], decayed["b"])


def test_adamw_schedule_matches_jax_in_fp32():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    for step in [0, 1, 3, 7, 8, 20, 49, 50, 80]:
        got = adamw.schedule(adamw.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        want = jadamw.schedule(jadamw.AdamWConfig(**cfg), jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# --------------------------------------------------------------------------
# the loss and its gradients through the whole tiny model
# --------------------------------------------------------------------------

def _batch(seed, b=2, s=16, vocab=256, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.fixture(scope="module")
def jax_loss_grads():
    """Per layout: the reference's jax.value_and_grad(loss_fn) in fp32 on its
    own params and one batch (computed once for the module)."""
    out = {}
    for layout, kw in LAYOUTS.items():
        jcfg, _ = _cfgs(dtype="float32", **kw)
        jparams = _j_params(jcfg, 0)
        batch = _batch(6)
        (loss, parts), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        out[layout] = (_np_tree(jparams), batch, float(loss), float(parts["ce"]),
                       _np_tree(grads))
    return out


def _port_loss_grads(cfg, flat_params, batch):
    params = params_from_numpy(flat_params, cfg, "cpu")
    leaves = [(p, t.requires_grad_(True)) for p, t in tree_flatten_with_paths(params)]
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, parts = steps.loss_fn(params, b, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, parts, {p: g for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(jax_loss_grads, layout, remat):
    """fp32 tiny smollm: the loss within 1e-6 and every gradient leaf within
    1e-5 of jax.value_and_grad of the reference's loss_fn (the port's
    attention is the plain version, the reference's its chunked twin: only
    the order of sums differs)."""
    flat, batch, jloss, jce, jgrads = jax_loss_grads[layout]
    _, cfg = _cfgs(dtype="float32", remat=remat, **LAYOUTS[layout])
    loss, parts, grads = _port_loss_grads(cfg, flat, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(parts["ce"].item(), jce, rtol=1e-6)
    assert parts["aux"].item() == 0.0
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_remat_does_not_change_gradients(layout):
    """remat none, full and dots give bit-identical gradients in the port
    (bf16, the training dtype): the recompute repeats the same arithmetic."""
    jcfg, _ = _cfgs(**LAYOUTS[layout])
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(1)))
    batch = _batch(7)
    results = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _cfgs(remat=remat, **LAYOUTS[layout])
        results[remat] = _port_loss_grads(cfg, flat, batch)
    loss0, _, g0 = results["none"]
    for remat in ("full", "dots"):
        loss, _, g = results[remat]
        assert torch.equal(loss, loss0), remat
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)


# --------------------------------------------------------------------------
# whole train steps
# --------------------------------------------------------------------------

N_STEPS = 5


def _run_both(dtype, layout):
    jcfg, cfg = _cfgs(dtype=dtype, **LAYOUTS[layout])
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jparams = _j_params(jcfg, 2)
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    state = _port_state(jstate, cfg)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**opt))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=3))
    jm, tm = [], []
    for i in range(N_STEPS):
        batch = data.batch_at(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, batch)
        jm.append({k: float(v) for k, v in jmet.items()})
        tm.append({k: float(v) for k, v in met.items()})
    return jstate, state, jm, tm


def _port_state(jstate, cfg):
    from repro_torch.convert import train_state_from_numpy
    return train_state_from_numpy(_np_tree(jstate), cfg, "cpu")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_five_train_steps_fp32_match_jax(layout):
    """fp32: every step's loss and grad norm within 1e-5 and the final
    params, m, v and master within 1e-5 of the reference's jitted
    make_train_step. Adam divides by sqrt(v), so a gradient that the two
    agree on to 1e-6 moves a param by the same lr-sized step: the
    parameters stay as close as the gradients."""
    jstate, state, jm, tm = _run_both("float32", layout)
    for a, b in zip(tm, jm):
        for key in ("loss", "ce", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    assert int(state.step) == N_STEPS
    want = _np_tree(jstate)
    for path, got in _flat_np(state).items():
        np.testing.assert_allclose(got, want[path].astype(np.float32), atol=1e-5, rtol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_five_train_steps_bf16_match_jax(layout):
    """bf16 (the training dtype): losses and grad norms within 2e-2 (the
    bf16 tolerance of tests/test_kernels.py) and the final params within
    2e-2. The two round at different points inside attention (the
    reference's chunked twin rounds q·scale and its probabilities to bf16,
    the port's plain version keeps them fp32) and bf16 gradients carry
    those differences into every Adam step."""
    jstate, state, jm, tm = _run_both("bfloat16", layout)
    for a, b in zip(tm, jm):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-2, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    want = _np_tree(jstate)
    for path, t in tree_flatten_with_paths(state.params):
        np.testing.assert_allclose(t.float().numpy(), want[f"params/{path}"].astype(np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=path)
    assert state.params["embed"].dtype == torch.bfloat16


def test_eval_step_matches_loss_fn():
    _, cfg = _cfgs(dtype="float32")
    params = steps.init_params(cfg, 0)
    batch = _batch(9)
    got = steps.make_eval_step(cfg)(params, batch)
    loss, _ = steps.loss_fn(params, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                            cfg)
    assert torch.equal(got["loss"], loss.detach()) and not got["loss"].requires_grad


# --------------------------------------------------------------------------
# the synthetic data stream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_batches_equal_reference(seed):
    kw = dict(vocab_size=257, seq_len=33, global_batch=6, seed=seed)
    for n_hosts, host in ((1, 0), (3, 2)):
        mine = SyntheticLM(DataConfig(**kw, n_hosts=n_hosts, host_index=host))
        theirs = JSyntheticLM(JDataConfig(**kw, n_hosts=n_hosts, host_index=host))
        for step in (0, 1, 17, 1000):
            a, b = mine.batch_at(step), theirs.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for key in a:
                assert a[key].dtype == b[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], b[key])


def test_prefetch_iterator_delivers_the_reference_batches_in_order():
    """The port's PrefetchIterator over its stream yields the reference's
    batches in step order, from a start step, and stops its thread."""
    from repro_torch.data.pipeline import PrefetchIterator
    kw = dict(vocab_size=50, seq_len=8, global_batch=2, seed=3)
    theirs = JSyntheticLM(JDataConfig(**kw))
    it = PrefetchIterator(SyntheticLM(DataConfig(**kw)).iterate(4), prefetch=2, workers=2,
                          prep_cost_s=0.002)
    try:
        for step in range(4, 9):
            got, want = next(it), theirs.batch_at(step)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    finally:
        it.close()
    it._thread.join(timeout=10)
    assert not it._thread.is_alive()


def test_shard_batch_with_no_mesh_gives_device_tensors():
    """With no mesh env, ``shard_batch`` is the host batch as tensors:
    integer arrays as int64, floating ones in their own dtype."""
    from repro_torch.data.pipeline import shard_batch
    batch = SyntheticLM(DataConfig(vocab_size=50, seq_len=8, global_batch=2)).batch_at(0)
    frames = np.ones((2, 3, 4), np.float32)
    out = shard_batch({**batch, "frames": frames})
    assert out["tokens"].dtype == out["labels"].dtype == torch.int64
    assert out["frames"].dtype == torch.float32
    assert torch.equal(out["tokens"], torch.from_numpy(batch["tokens"]).long())


@pytest.mark.gpu
def test_remat_policies_agree_on_card():
    """On the card, through the flash kernels: remat none, full and dots give
    bit-identical gradients, and remat reruns each layer's forward kernel
    in the backward (2 forward launches a layer under full and dots, 1
    under none; 1 backward launch a layer under all three)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels train there")
    from repro_torch.launch.train import deterministic

    deterministic(torch.device("cuda"))
    jcfg, _ = _cfgs(**LAYOUTS["stacked"])
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(1)))
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in _batch(7).items()}
    results = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _cfgs(remat=remat, **LAYOUTS["stacked"])
        params = params_from_numpy(flat, cfg, "cuda")
        leaves = [(p, t.requires_grad_(True)) for p, t in tree_flatten_with_paths(params)]
        ops.reset_launch_counts()
        loss, _ = steps.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        torch.cuda.synchronize()
        results[remat] = (loss, grads, ops.launch_counts())
    n = jcfg.n_layers
    for remat, (loss, grads, launches) in results.items():
        want = {"flash_attention": n * (1 if remat == "none" else 2),
                "flash_attention_bwd": n, "rglru_scan": 0, "rglru_scan_bwd": 0}
        assert launches == want, (remat, launches)
        assert torch.equal(loss, results["none"][0]), remat
        for g, g0 in zip(grads, results["none"][1]):
            assert torch.equal(g, g0), remat
