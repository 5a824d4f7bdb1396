"""The port's recurrentgemma-2b training slice (repro_torch) against the JAX
package on the CPU: the RG-LRU scan's backward (its plain version, which
``csrc/rglru_bwd.cu`` equals bit for bit on the card, and ``RGLRUScanFn``'s
wiring), the rglru block in train mode, the loss and every gradient of the
tiny hybrid model, five train steps, a train state's checkpoint across
packages and the train CLI's crash-resume.

The JAX package materializes the params and ``repro_torch.convert`` loads
them; inputs are made with numpy from fixed seeds. On the CPU the port's
kernels are their plain versions, which carry autograd. Tolerances are
stated where they are used: fp32 comparisons at 1e-5 or tighter, bf16 ones
at 2e-2, the bf16 tolerance of tests/test_kernels.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_tiny_config as jget_tiny
from repro.data.objectstore import MountedBucket as JMountedBucket
from repro.data.objectstore import ObjectStore
from repro.kernels import ref as jref
from repro.models import steps as jsteps
from repro.nn import blocks as jblocks
from repro.nn import params as jprm
from repro.nn import recurrent as jrec
from repro.optim import adamw as jadamw
from repro.utils.trees import path_str
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_tiny_config
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data.objectstore import DirBucket
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as krglru
from repro_torch.launch import train as train_cli
from repro_torch.models import steps
from repro_torch.nn import blocks, recurrent
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

ARCH = "recurrentgemma-2b"


def _np_tree(jtree):
    return {p: np.asarray(x) for p, x in jflatten(jtree)}


def _np_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its uint16 words)."""
    t = t.detach().contiguous()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def _jnp_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rel_close(got, want, tol, what=""):
    """|got - want| within ``tol`` of the largest |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol:g} x {scale:.3e}"


# --------------------------------------------------------------------------
# the scan's backward: the plain version
# --------------------------------------------------------------------------

# (B, S, W, with h0, with g_last)
SCAN_CASES = [(2, 37, 16, False, False), (2, 37, 16, True, False), (2, 37, 16, False, True),
              (2, 37, 16, True, True), (3, 1, 8, True, True), (1, 1, 5, False, False),
              (2, 70, 37, True, True), (1, 130, 33, False, True)]
SCAN_IDS = [f"B{b}S{s}W{w}{'_h0' if h0 else ''}{'_glast' if gl else ''}"
            for b, s, w, h0, gl in SCAN_CASES]


def _scan_np(b, s, w, with_h0, with_gl, seed=0):
    """a in (0.5, 1) (the model's decays), b, the output gradient g, h0 and
    g_last, fp32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w)).astype(np.float32)
    g = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    gl = rng.standard_normal((b, w)).astype(np.float32) if with_gl else None
    return a, bb, g, h0, gl


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("b,s,w,with_h0,with_gl", SCAN_CASES, ids=SCAN_IDS)
def test_scan_bwd_ref_matches_autograd_and_jax_vjp(b, s, w, with_h0, with_gl):
    """``rglru_scan_bwd_ref`` against torch autograd through the plain scan
    and against jax.vjp of the reference's ``kernels/ref.rglru_scan_ref``
    (a lax.scan), within 1e-6 of each gradient's largest magnitude."""
    a, bb, g, h0, gl = _scan_np(b, s, w, with_h0, with_gl)
    ta, tb = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(bb).requires_grad_(True)
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    h, h_last = ref.rglru_scan_ref(ta, tb, th0)
    inputs = [ta, tb] + ([th0] if with_h0 else [])
    outs, grads_out = [h], [torch.from_numpy(g)]
    if with_gl:
        outs.append(h_last)
        grads_out.append(torch.from_numpy(gl))
    want = torch.autograd.grad(outs, inputs, grads_out)
    da, db, dh0 = ref.rglru_scan_bwd_ref(ta.detach(), h.detach(), torch.from_numpy(g),
                                         None if th0 is None else th0.detach(), _t(gl))
    got = [da, db] + ([dh0] if with_h0 else [])
    assert (dh0 is None) == (not with_h0)
    assert all(x.dtype == torch.float32 for x in got)

    def jfn(a, b, h0):
        return jref.rglru_scan_ref(a, b, h0)

    jh0 = None if h0 is None else jnp.asarray(h0)
    (_, _), vjp = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(bb), jh0)
    jg_last = jnp.asarray(gl) if with_gl else jnp.zeros((b, w), jnp.float32)
    jgrads = vjp((jnp.asarray(g), jg_last))
    for i, (x, y) in enumerate(zip(got, want)):
        _rel_close(x.numpy(), y.numpy(), 1e-6, f"autograd grad {i}")
        _rel_close(x.numpy(), np.asarray(jgrads[i]), 1e-6, f"jax.vjp grad {i}")


def test_scan_bwd_ref_with_exact_zero_and_one_decays():
    """a exactly 0 (the carry stops) and 1 (it passes unchanged) on two
    lanes in three: still autograd's gradients, bit for bit here."""
    a, bb, g, h0, gl = _scan_np(2, 50, 9, True, True, seed=3)
    a[..., 0::3], a[..., 1::3] = 0.0, 1.0
    ta, tb, th0 = (torch.from_numpy(x).requires_grad_(True) for x in (a, bb, h0))
    h, h_last = ref.rglru_scan_ref(ta, tb, th0)
    want = torch.autograd.grad([h, h_last], [ta, tb, th0], [torch.from_numpy(g), _t(gl)])
    got = ref.rglru_scan_bwd_ref(ta.detach(), h.detach(), torch.from_numpy(g), th0.detach(),
                                 _t(gl))
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    # no carry crosses a zero decay: dh0 is 0 on those lanes
    assert torch.equal(got[2][:, 0::3], torch.zeros_like(got[2][:, 0::3]))


def _lru_flat(w=64, n_heads=2, seed=4):
    rng = np.random.default_rng(seed)
    bw = w // n_heads
    return {"a_gate/w": (rng.standard_normal((n_heads, bw, bw)) / math.sqrt(bw)).astype(np.float32),
            "a_gate/b": rng.standard_normal((n_heads, bw)).astype(np.float32),
            "i_gate/w": (rng.standard_normal((n_heads, bw, bw)) / math.sqrt(bw)).astype(np.float32),
            "i_gate/b": rng.standard_normal((n_heads, bw)).astype(np.float32),
            "lam": rng.standard_normal(w).astype(np.float32)}


@pytest.fixture
def scan_fn_on_cpu(monkeypatch):
    """``ops.rglru_scan`` routed through ``RGLRUScanFn`` on the CPU, with the
    plain versions swapped in for the two kernels: the Function's wiring,
    which the card runs with the kernels. Returns the calls recorded."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(a, b, h0=None):
        calls["fwd"] += 1
        return ref.rglru_scan_ref(a, b, h0)

    def bwd(a, h, g, h0=None, g_last=None):
        calls["bwd"] += 1
        calls["bwd_args"] = (a, h, g, h0, g_last)
        return ref.rglru_scan_bwd_ref(a, h, g, h0, g_last)

    monkeypatch.setattr(krglru, "rglru_scan_cuda", fwd)
    monkeypatch.setattr(krglru, "rglru_scan_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "rglru_scan",
                        lambda a, b, h0=None, force=None: krglru.RGLRUScanFn.apply(a, b, h0))
    return calls


@pytest.mark.parametrize("with_h0", [False, True])
def test_model_rglru_grads_through_the_backward_match_jax_associative_scan(scan_fn_on_cpu,
                                                                           with_h0):
    """The port's ``nn/recurrent.rglru`` with its scan differentiated by the
    plain backward (``RGLRUScanFn``) against jax.vjp of the reference
    model's ``rglru``, which runs jax.lax.associative_scan: the gradients
    of x, h0 and every parameter within 1e-5 (fp32; the two scans associate
    differently)."""
    flat = _lru_flat()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 23, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 else None
    gy = rng.standard_normal((2, 23, 64)).astype(np.float32)
    gl = rng.standard_normal((2, 64)).astype(np.float32)

    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in flat.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    y, h_last = recurrent.rglru(tree_unflatten(p), tx, 2, th0)
    assert type(y.grad_fn).__name__ == "RGLRUScanFnBackward"  # fp32: h itself
    leaves = [tx] + ([th0] if with_h0 else []) + list(p.values())
    got = torch.autograd.grad([y, h_last], leaves, [torch.from_numpy(gy), torch.from_numpy(gl)])
    assert scan_fn_on_cpu == {**scan_fn_on_cpu, "fwd": 1, "bwd": 1}

    def jfn(x, h0, params):
        return jrec.rglru(tree_unflatten(params), x, 2, h0)

    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    _, vjp = jax.vjp(jfn, jnp.asarray(x), None if h0 is None else jnp.asarray(h0), jparams)
    jgx, jgh0, jgp = vjp((jnp.asarray(gy), jnp.asarray(gl)))
    want = [jgx] + ([jgh0] if with_h0 else []) + [jgp[k] for k in p]
    names = ["x"] + (["h0"] if with_h0 else []) + list(p)
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


def test_scan_fn_saves_a_h_h0_and_returns_dh0(scan_fn_on_cpu):
    """``RGLRUScanFn`` saves a, the output h and h0 (not b), hands the
    backward both output gradients and returns (da, db, dh0): autograd's
    gradients through the plain scan, bit for bit."""
    a, bb, g, h0, gl = _scan_np(2, 30, 12, True, True, seed=7)
    ta, tb, th0 = (torch.from_numpy(x).requires_grad_(True) for x in (a, bb, h0))
    h, h_last = ops.rglru_scan(ta, tb, th0)
    assert type(h.grad_fn).__name__ == "RGLRUScanFnBackward"
    a_saved, h_saved, h0_saved = h.grad_fn.saved_tensors
    assert torch.equal(a_saved, ta) and torch.equal(h_saved, h) and torch.equal(h0_saved, th0)
    got = torch.autograd.grad([h, h_last], [ta, tb, th0], [torch.from_numpy(g), _t(gl)])
    assert scan_fn_on_cpu["bwd"] == 1 and scan_fn_on_cpu["bwd_args"][4] is not None
    pa, pb, ph0 = (torch.from_numpy(x).requires_grad_(True) for x in (a, bb, h0))
    ph, ph_last = ref.rglru_scan_ref(pa, pb, ph0)
    want = torch.autograd.grad([ph, ph_last], [pa, pb, ph0], [torch.from_numpy(g), _t(gl)])
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_scan_fn_without_h0_or_h_last_grad(scan_fn_on_cpu):
    """No h0: the Function saves None and returns no dh0; h_last unused: the
    backward gets None for its gradient (no zeros materialized) and the
    kernel starts the walk from g alone."""
    a, bb, g, _, _ = _scan_np(2, 30, 12, False, False, seed=8)
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, bb))
    h, _ = ops.rglru_scan(ta, tb)
    assert h.grad_fn.saved_tensors[2] is None
    got = torch.autograd.grad(h, [ta, tb], torch.from_numpy(g))
    args = scan_fn_on_cpu["bwd_args"]
    assert args[3] is None and args[4] is None
    pa, pb = (torch.from_numpy(x).requires_grad_(True) for x in (a, bb))
    want = torch.autograd.grad(ref.rglru_scan_ref(pa, pb)[0], [pa, pb], torch.from_numpy(g))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_scan_fn_with_only_h_last_used(scan_fn_on_cpu):
    """Only h_last reaches the loss: the backward gets zeros for h's
    gradient and g_last for h_last's."""
    a, bb, _, h0, gl = _scan_np(1, 9, 4, True, True, seed=9)
    ta, tb, th0 = (torch.from_numpy(x).requires_grad_(True) for x in (a, bb, h0))
    _, h_last = ops.rglru_scan(ta, tb, th0)
    got = torch.autograd.grad(h_last, [ta, tb, th0], torch.from_numpy(gl))
    pa, pb, ph0 = (torch.from_numpy(x).requires_grad_(True) for x in (a, bb, h0))
    want = torch.autograd.grad(ref.rglru_scan_ref(pa, pb, ph0)[1], [pa, pb, ph0],
                               torch.from_numpy(gl))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_scan_fn_refuses_bf16(scan_fn_on_cpu):
    """The backward kernel takes fp32; the model's coefficients are fp32.
    bf16 a and b under grad raise ValueError before any launch."""
    a, bb, _, _, _ = _scan_np(1, 8, 4, False, False)
    ta = torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(bb).to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan(ta, tb)
    assert scan_fn_on_cpu["fwd"] == 0


def test_scan_bwd_kernel_wrapper_refuses_cpu_tensors():
    """The backward's wrapper takes CUDA tensors only: no fallback."""
    a, bb, g, _, _ = _scan_np(1, 8, 4, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        krglru.rglru_scan_bwd_cuda(torch.from_numpy(a), torch.from_numpy(bb),
                                   torch.from_numpy(g))


def test_dispatcher_under_grad_on_cpu_takes_the_plain_scan():
    """On the CPU, under grad, the dispatcher runs the plain scan (which
    carries autograd itself) and counts no launch."""
    a, bb, _, _, _ = _scan_np(1, 8, 4, False, False)
    ta = torch.from_numpy(a).requires_grad_(True)
    before = ops.launch_counts()
    h, _ = ops.rglru_scan(ta, torch.from_numpy(bb))
    assert type(h.grad_fn).__name__ != "RGLRUScanFnBackward" and h.requires_grad
    assert ops.launch_counts() == before
    assert set(before) == {"flash_attention", "flash_attention_bwd", "rglru_scan",
                           "rglru_scan_bwd"}


# --------------------------------------------------------------------------
# the rglru block in train mode
# --------------------------------------------------------------------------

BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _block_flat(seed=7):
    """The tiny config's rglru block, reference-initialized, with a nonzero
    lam and conv bias so that every term is exercised."""
    jcfg = jget_tiny(ARCH)
    flat = _np_tree(jprm.materialize(jax.random.key(seed), jblocks.def_rglru_block(jcfg),
                                     jnp.float32))
    rng = np.random.default_rng(seed)
    flat["lru/lam"] = rng.standard_normal(flat["lru/lam"].shape).astype(np.float32)
    flat["conv/b"] = 0.1 * rng.standard_normal(flat["conv/b"].shape).astype(np.float32)
    return flat


def _cast(flat, dtype):
    """{path: fp32 numpy} in ``dtype``; lam and the norm scales stay fp32,
    as the models keep them. Returns (jax dict, torch dict)."""
    jt, tt = {}, {}
    for p, a in flat.items():
        keep = p.rsplit("/", 1)[-1] in ("lam", "scale")
        jt[p] = jnp.asarray(a).astype(jnp.float32 if keep else jnp.dtype(dtype))
        tt[p] = torch.tensor(a).to(torch.float32 if keep else getattr(torch, dtype))
    return jt, tt


@pytest.mark.parametrize("dtype", list(BLOCK_TOL))
def test_apply_rglru_block_train_matches_jax(dtype):
    """``apply_rglru_block(mode="train")``: the output (and no state), and
    the gradients of x and of every parameter by jax.vjp of the reference's
    train-mode block, within 1e-5 (fp32) or 2e-2 (bf16) of each one's
    largest magnitude."""
    tol = BLOCK_TOL[dtype]
    jcfg, cfg = jget_tiny(ARCH).replace(dtype=dtype), get_tiny_config(ARCH).replace(dtype=dtype)
    jflat, tflat = _cast(_block_flat(), dtype)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    gy = rng.standard_normal((2, 9, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)

    leaves = {k: v.requires_grad_(True) for k, v in tflat.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y, state = blocks.apply_rglru_block(tree_unflatten(leaves), tx, cfg, mode="train")
    assert state is None and y.dtype == tdt
    grads = torch.autograd.grad(y, [tx, *leaves.values()], torch.from_numpy(gy).to(tdt))

    def jfn(x, params):
        out, st, _ = jblocks.apply_rglru_block(tree_unflatten(params), x, jcfg, mode="train")
        assert st is None
        return out

    jy, vjp = jax.vjp(jfn, jnp.asarray(x).astype(jnp.dtype(dtype)), jflat)
    jgx, jgp = vjp(jnp.asarray(gy).astype(jnp.dtype(dtype)))
    _rel_close(y.float().detach().numpy(), np.asarray(jy, np.float32), tol, "y")
    _rel_close(grads[0].float().numpy(), np.asarray(jgx, np.float32), tol, "dx")
    for name, g in zip(leaves, grads[1:]):
        assert g.dtype == leaves[name].dtype, name
        _rel_close(g.float().numpy(), np.asarray(jgp[name], np.float32), tol, name)


def test_apply_rglru_block_train_equals_prefill_output():
    """Train mode computes what prefill computes from no state."""
    _, tflat = _cast(_block_flat(), "float32")
    cfg = get_tiny_config(ARCH).replace(dtype="float32")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 11, 64)).astype(np.float32))
    p = tree_unflatten(tflat)
    y_train, _ = blocks.apply_rglru_block(p, x, cfg, mode="train")
    y_prefill, _ = blocks.apply_rglru_block(p, x, cfg, mode="prefill")
    assert torch.equal(y_train, y_prefill)


# --------------------------------------------------------------------------
# the tiny hybrid model: loss, gradients, remat, train steps
# --------------------------------------------------------------------------

def _cfgs(**kw):
    return jget_tiny(ARCH).replace(**kw), get_tiny_config(ARCH).replace(**kw)


def _true_fan_in(jparams, cfg):
    """The attention projections rescaled to their true fan-in
    (chip_smoke.true_fan_in). The reference init divides by the heads axis,
    which is 1 for MQA's wk/wv: k gets std 1 instead of 1/8 and attention
    is nearly one-hot (ROADMAP C.6), and the loss is so ill-conditioned that
    rounding differences grow to 1e-4 of a gradient: on the default init
    the reference against itself, with only its scan's association changed
    (associative against sequential), differs by 3.1e-4 in fp32, and the
    port's gradients are 1.1e-4 from it. On these weights the reference
    against itself differs by 4e-7 and the port is 5.7e-7 from it."""
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


def _batch(seed, b=2, s=24, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.fixture(scope="module")
def jax_loss_grads():
    """The reference's jax.value_and_grad(loss_fn) in fp32 on its own params
    at true fan-in (``_true_fan_in``) and one batch that crosses the tiny
    config's 32-token window (computed once for the module)."""
    jcfg, _ = _cfgs(dtype="float32")
    jparams = _true_fan_in(jsteps.init_params(jcfg, jax.random.key(0)), jcfg)
    batch = _batch(6, s=40)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return _np_tree(jparams), batch, float(loss), float(parts["ce"]), _np_tree(grads)


def _port_loss_grads(cfg, flat_params, batch):
    params = params_from_numpy(flat_params, cfg, "cpu")
    leaves = [(p, t.requires_grad_(True)) for p, t in tree_flatten_with_paths(params)]
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, parts = steps.loss_fn(params, b, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, parts, {p: g for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(jax_loss_grads, remat):
    """fp32 tiny recurrentgemma (rglru, rglru, attn): the loss within 1e-6
    and every gradient leaf within 1e-5 of jax.value_and_grad of the
    reference's loss_fn (the port's scan is sequential where the
    reference's is associative, and its attention the plain version where
    the reference's is the chunked twin: only the order of sums differs)."""
    flat, batch, jloss, jce, jgrads = jax_loss_grads
    _, cfg = _cfgs(dtype="float32", remat=remat)
    loss, parts, grads = _port_loss_grads(cfg, flat, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(parts["ce"].item(), jce, rtol=1e-6)
    assert parts["aux"].item() == 0.0
    assert set(grads) == set(jgrads)
    assert any("lru/lam" in p for p in grads) and any("attn/wq" in p for p in grads)
    for path, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-5,
                                   err_msg=path)


@pytest.fixture(scope="module")
def jax_loss_grads_d256():
    """As ``jax_loss_grads``, for the tiny config at head_dim 256 (the
    fp32 job manifest's overrides, chip_smoke.FP32_JOB): the reference's
    loss and gradients of one fp32 train step, on a batch that crosses the
    32-token window."""
    jcfg, _ = _cfgs(dtype="float32", head_dim=256)
    jparams = _true_fan_in(jsteps.init_params(jcfg, jax.random.key(3)), jcfg)
    batch = _batch(8, s=40)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return _np_tree(jparams), batch, float(loss), float(parts["ce"]), _np_tree(grads)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_head_dim_256_fp32_loss_and_grads_match_jax(jax_loss_grads_d256, remat):
    """fp32 tiny recurrentgemma at head_dim 256 (225,792 params; the path
    of the fp32 flash backward at head_dim 256 and the scan's backward on
    the card): the loss and every gradient leaf within 1e-5 of
    jax.value_and_grad of the reference's loss_fn, from the reference's
    weights carried by ``convert.params_from_numpy``."""
    flat, batch, jloss, jce, jgrads = jax_loss_grads_d256
    _, cfg = _cfgs(dtype="float32", head_dim=256, remat=remat)
    assert cfg.param_count() == 225_792
    loss, parts, grads = _port_loss_grads(cfg, flat, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    np.testing.assert_allclose(parts["ce"].item(), jce, rtol=1e-5)
    assert set(grads) == set(jgrads)
    assert any(p.endswith("attn/wq") and grads[p].shape[-1] == 256 for p in grads)
    for path, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-5,
                                   err_msg=path)


def test_remat_does_not_change_gradients():
    """remat none, full and dots give bit-identical gradients in the port's
    hybrid list layout (bf16, the training dtype): the recompute repeats
    the same arithmetic, the scan's included."""
    jcfg, _ = _cfgs()
    flat = _np_tree(jsteps.init_params(jcfg, jax.random.key(1)))
    batch = _batch(7)
    results = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _cfgs(remat=remat)
        results[remat] = _port_loss_grads(cfg, flat, batch)
    loss0, _, g0 = results["none"]
    for remat in ("full", "dots"):
        loss, _, g = results[remat]
        assert torch.equal(loss, loss0), remat
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)


N_STEPS = 5


def _run_both(dtype):
    jcfg, cfg = _cfgs(dtype=dtype)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jparams = _true_fan_in(jsteps.init_params(jcfg, jax.random.key(2)), jcfg)
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    state = train_state_from_numpy(_np_tree(jstate), cfg, "cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**opt))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 40, 4, seed=3))
    jm, tm = [], []
    for i in range(N_STEPS):
        batch = data.batch_at(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, batch)
        jm.append({k: float(v) for k, v in jmet.items()})
        tm.append({k: float(v) for k, v in met.items()})
    return jstate, state, jm, tm


def test_five_train_steps_fp32_match_jax():
    """fp32, on the reference's weights at true fan-in (``_true_fan_in``):
    every step's loss and grad norm within 1e-5 and the final params, m, v
    and master within 1e-5 of the reference's jitted make_train_step."""
    jstate, state, jm, tm = _run_both("float32")
    for a, b in zip(tm, jm):
        for key in ("loss", "ce", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    assert int(state.step) == N_STEPS
    want = _np_tree(jstate)
    for path, got in tree_flatten_with_paths(state):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   want[path].astype(np.float32), atol=1e-5, rtol=1e-5,
                                   err_msg=path)


def test_five_train_steps_bf16_match_jax():
    """bf16 (the training dtype), on the reference's weights with the
    attention projections at their true fan-in (``_true_fan_in``, as
    tests/test_torch_recurrent.py's bf16 logits test does): losses and grad
    norms within 2e-2 and the final params within 2e-2. The two round at
    different points (ROADMAP C.8: the rglru gate, the MLP, attention's
    probabilities) and bf16 gradients carry those differences into every
    Adam step."""
    jstate, state, jm, tm = _run_both("bfloat16")
    for a, b in zip(tm, jm):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-2, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    want = _np_tree(jstate)
    for path, t in tree_flatten_with_paths(state.params):
        np.testing.assert_allclose(t.float().numpy(), want[f"params/{path}"].astype(np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=path)
    assert state.params["blocks"]["layers"][0]["lru"]["lam"].dtype == torch.float32
    assert state.params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_step_equals_functional_update(dtype):
    """The train step consumes its state (AdamW in place, the state donated
    as the reference's CLI donates it): over three steps it gives the state
    that the functional ``adamw.update`` gives from the same gradients, bit
    for bit, and returns the tensors it was given."""
    _, cfg = _cfgs(dtype=dtype)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, seed=4))
    step = steps.make_train_step(cfg, opt)

    def functional(state, batch):
        flat = tree_flatten_with_paths(state.params)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        params = tree_unflatten({p: t for (p, _), t in zip(flat, leaves)})
        b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        loss, _ = steps.loss_fn(params, b, cfg)
        grads = torch.autograd.grad(loss, leaves)
        grads = tree_unflatten({p: g for (p, _), g in zip(flat, grads)})
        params, opt_state, _ = adamw.update(opt, grads, state.opt, state.step)
        return steps.TrainState(state.step + 1, params, opt_state), loss

    a, b = steps.init_train_state(cfg, 5), steps.init_train_state(cfg, 5)
    for i in range(3):
        embed = b.params["embed"]
        a, loss = functional(a, data.batch_at(i))
        b, mb = step(b, data.batch_at(i))
        assert b.params["embed"] is embed  # updated where it lay
        assert torch.equal(loss.detach(), mb["loss"])
    for (path, x), (_, y) in zip(tree_flatten_with_paths(a), tree_flatten_with_paths(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# --------------------------------------------------------------------------
# checkpoints across packages, and the train CLI
# --------------------------------------------------------------------------

@pytest.fixture
def bucket():
    store = ObjectStore()
    store.create_bucket("b")
    return JMountedBucket(store, "b")


def test_reference_train_state_restores_in_the_port_bit_for_bit(bucket):
    """A recurrentgemma train state after a reference step (every leaf off
    its init), saved by the reference, restores in the port bit for bit,
    lam and the norm scales fp32, the rest bf16."""
    jcfg, cfg = _cfgs()
    jparams = jsteps.init_params(jcfg, jax.random.key(3))
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    batch = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    jstate, _ = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(warmup_steps=0)))(
        jstate, batch)
    jckpt.save(bucket, "ck", 1, jstate, {"loss": 1.5})
    flat, meta = ckpt.restore(bucket, "ck", 1)
    assert meta == {"loss": 1.5}
    want = dict(jflatten(jstate))
    assert set(flat) == set(want)
    for path, t in flat.items():
        np.testing.assert_array_equal(_np_bits(t), _jnp_bits(want[path]), err_msg=path)
    state = train_state_from_numpy(flat, cfg, "cpu")
    assert int(state.step) == 1
    assert state.params["blocks"]["layers"][2]["attn"]["wq"].dtype == torch.bfloat16
    assert state.params["blocks"]["layers"][0]["lru"]["lam"].dtype == torch.float32


def test_port_train_state_restores_in_the_reference_bit_for_bit(bucket):
    """A port recurrentgemma train state after a port step restores in the
    reference bit for bit, against its abstract train state."""
    _, cfg = _cfgs()
    state = steps.init_train_state(cfg, 4)
    state, _ = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))(state, _batch(3))
    ckpt.save(bucket, "ck", 1, state, {"loss": 2.5})
    restored, meta = jckpt.restore(bucket, "ck", 1,
                                   like=jsteps.abstract_train_state(jget_tiny(ARCH)))
    assert meta == {"loss": 2.5}
    got = dict(jflatten(restored))
    for path, t in tree_flatten_with_paths(state):
        g = np.asarray(got[path])
        assert g.shape == tuple(t.shape) and str(g.dtype) == str(t.dtype).split(".")[-1], path
        np.testing.assert_array_equal(_jnp_bits(g), _np_bits(t), err_msg=path)


class _Crash(Exception):
    pass


def test_train_cli_crash_resume_is_bit_equal(tmp_path, monkeypatch, capsys):
    """``launch.train --arch recurrentgemma-2b --tiny --device cpu``, 8 steps
    with checkpoints every 4: a run that crashes in step 6 (after its step-4
    checkpoint is written) and is started again with the same arguments
    resumes from step 4 and ends on the uninterrupted run's final
    checkpoint bit for bit."""
    base = ["--arch", ARCH, "--tiny", "--device", "cpu", "--batch", "2", "--seq", "24",
            "--log-every", "4", "--ckpt-every", "4", "--warmup", "2", "--steps", "8"]
    train_cli.main(base + ["--ckpt-dir", str(tmp_path / "a")])

    checkpointers, make_step = [], steps.make_train_step
    init = ckpt.AsyncCheckpointer.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        checkpointers.append(self)

    def crashing_make_step(*args, **kwargs):
        step, calls = make_step(*args, **kwargs), []

        def crashing(state, batch):
            calls.append(1)
            if len(calls) == 6:
                for c in checkpointers:
                    c.wait()  # the step-4 checkpoint is on disk, as a crash finds it
                raise _Crash
            return step(state, batch)

        return crashing

    with monkeypatch.context() as m:
        m.setattr(ckpt.AsyncCheckpointer, "__init__", recording_init)
        m.setattr(steps, "make_train_step", crashing_make_step)
        with pytest.raises(_Crash):
            train_cli.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    crashed = DirBucket(str(tmp_path / "b"))
    assert ckpt.steps_available(crashed, "ckpt") == [4]
    capsys.readouterr()
    state = train_cli.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 4" in out and "step     8 loss" in out
    assert int(state.step) == 8
    want, _ = ckpt.restore(DirBucket(str(tmp_path / "a")), "ckpt", 8)
    got, _ = ckpt.restore(crashed, "ckpt", 8)
    assert set(got) == set(want) and len(got) > 100
    for path in want:
        assert got[path].dtype == want[path].dtype and torch.equal(got[path], want[path]), path
