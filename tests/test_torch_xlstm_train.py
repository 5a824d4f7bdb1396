"""The port's xlstm-125m training slice against the JAX package, on the CPU:
the mLSTM's and sLSTM's gradients, both blocks in train mode, the tiny
model's loss and every gradient under remat none/full/dots across mLSTM
chunk boundaries, train steps, train states across packages, and the train
CLI's and ``TorchLearner``'s crash-resume.

The JAX package materializes the params, with the zero-init biases and the
norms redrawn (``test_torch_xlstm.redraw_biases``); xlstm's projections are
at their true fan-in on the reference init (it has no attention block,
ROADMAP C.9). ``repro_torch.convert`` loads the same arrays. Tolerances:
fp32 gradients at atol = rtol = 1e-5, bf16 at 2e-2 of each gradient's
largest magnitude; the reference's jitted steps. In bf16 the reference's
jitted step keeps some intermediate roundings in fp32 (XLA's excess
precision on the CPU), so bf16 is held at the bf16 tolerance of the other
archs' steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_mirror import one_thread  # noqa: F401 (a fixture)
from test_torch_learner import torch_learners  # noqa: F401 (a fixture)
from test_torch_recurrent_train import _Crash, _jnp_bits, _np_bits, _np_tree, _rel_close
from test_torch_recurrent_train import bucket  # noqa: F401 (a fixture)
from test_torch_xlstm import (
    _APPLY,
    _mlstm_np,
    _mlstm_state_np,
    _slstm_np,
    block_flat,
    model_params,
)

from repro.api import ApiClient
from repro.ckpt import checkpoint as jckpt
from repro.configs import get_tiny_config as jget_tiny
from repro.core import FfDLPlatform, JobManifest, JobStatus
from repro.models import steps as jsteps
from repro.nn import recurrent as jrec
from repro.optim import adamw as jadamw
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_tiny_config
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data.objectstore import DirBucket, MountedBucket
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import steps
from repro_torch.nn import recurrent
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

ARCH = "xlstm-125m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _grads(outs, inputs, cots):
    return torch.autograd.grad(outs, inputs, cots)


def _t32(arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(True) for a in arrays]


# --------------------------------------------------------------------------
# the mLSTM and the sLSTM: gradients against jax.vjp
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_grads_match_jax_vjp(with_state):
    """fp32, chunk 16 over 64 steps (4 chunks): the gradients of q, k, v,
    both gates and the initial (C, n, m), given cotangents of h and of the
    final C and n, within 1e-5 of each gradient's largest magnitude of
    jax.vjp of the reference. (Elementwise, a few of k's 12,288 entries
    differ by up to 2.5e-5 at |dk| near 1: h divides by a normalizer that
    nearly cancels at some positions, which amplifies fp32 rounding in
    either package.)"""
    arrays = [np.asarray(a, np.float32) for a in _mlstm_np(30)]
    st = [np.asarray(a, np.float32) for a in _mlstm_state_np(31)] if with_state else []
    rng = np.random.default_rng(32)
    gh = rng.standard_normal((2, 2, 64, 32)).astype(np.float32)
    gc = rng.standard_normal((2, 2, 48, 32)).astype(np.float32)
    gn = rng.standard_normal((2, 2, 48)).astype(np.float32)
    tx, tst = _t32(arrays), _t32(st)
    h, fin = recurrent.mlstm_chunkwise(*tx, state=recurrent.MLSTMState(*tst) if st else None,
                                       chunk=16)
    got = _grads([h, fin.c, fin.n], tx + tst, [torch.from_numpy(g) for g in (gh, gc, gn)])

    def jfn(*xs):
        state = jrec.MLSTMState(*xs[5:]) if st else None
        jh, jfin = jrec.mlstm_chunkwise(*xs[:5], state=state, chunk=16)
        return jh, jfin.c, jfin.n

    _, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays + st])
    want = vjp((jnp.asarray(gh), jnp.asarray(gc), jnp.asarray(gn)))
    names = ["q", "k", "v", "i", "f"] + ["c0", "n0", "m0"][:len(st)]
    for name, g, w in zip(names, got, want, strict=True):
        _rel_close(g.numpy(), np.asarray(w), 1e-5, name)


def test_slstm_scan_grads_match_jax_vjp():
    """fp32, 20 steps from a given state: the gradients of the four gates'
    inputs, the four recurrent weights and the initial (c, n, m, h), given
    cotangents of h and the final c, within atol = rtol = 1e-5."""
    r, gates, st = _slstm_np(33)
    rng = np.random.default_rng(34)
    gh = rng.standard_normal((2, 2, 20, 16)).astype(np.float32)
    gc = rng.standard_normal((2, 2, 16)).astype(np.float32)
    rnames, gnames = sorted(r), sorted(gates)
    leaves = _t32([r[k] for k in rnames] + [gates[k] for k in gnames] + list(st))
    tr = dict(zip(rnames, leaves[:4]))
    tg = dict(zip(gnames, leaves[4:8]))
    h, fin = recurrent.slstm_scan(tr, tg, recurrent.SLSTMState(*leaves[8:]))
    got = _grads([h, fin.c], leaves, [torch.from_numpy(gh), torch.from_numpy(gc)])

    def jfn(*xs):
        jh, jfin = jrec.slstm_scan(dict(zip(rnames, xs[:4])), dict(zip(gnames, xs[4:8])),
                                   jrec.SLSTMState(*xs[8:]))
        return jh, jfin.c

    _, vjp = jax.vjp(jfn, *[jnp.asarray(t.detach().numpy()) for t in leaves])
    want = vjp((jnp.asarray(gh), jnp.asarray(gc)))
    names = rnames + gnames + ["c0", "n0", "m0", "h0"]
    for name, g, w in zip(names, got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


# --------------------------------------------------------------------------
# the blocks in train mode
# --------------------------------------------------------------------------

def _cast(flat, dtype):
    """{path: fp32 numpy} → (jax dict, torch dict) in ``dtype``, the output
    norms and norm scales fp32."""
    jt, tt = {}, {}
    for p, a in flat.items():
        keep = p.rsplit("/", 1)[-1] in ("out_norm", "scale")
        jt[p] = jnp.asarray(a).astype(jnp.float32 if keep else jnp.dtype(dtype))
        tt[p] = torch.tensor(a).to(torch.float32 if keep else getattr(torch, dtype))
    return jt, tt


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_train_matches_jax_vjp(kind, dtype):
    """``apply_{kind}_block(mode="train")`` at attn_chunk 16 over 32 tokens
    (two mLSTM chunks): the output, and the gradients of x and of every
    parameter by jax.vjp of the reference's train-mode block, within 1e-5
    (fp32) or 2e-2 (bf16) of each one's largest magnitude. The gate biases'
    gradients are sums over the 64 positions of per-position gradients
    that cancel (the mLSTM's bi to under 0.05% of the sum of their
    magnitudes, about 130, here; against its fp64 value both packages miss
    by about 2e-6 in fp32, and in bf16 the port by up to 0.07 and the
    reference by up to 0.13): they are held to the tolerance times that sum
    of per-position magnitudes, from the port's gradients with the biases
    broadcast over (B, S)."""
    tol = TOL[dtype]
    jcfg = jget_tiny(ARCH).replace(dtype=dtype, attn_chunk=16)
    cfg = get_tiny_config(ARCH).replace(dtype=dtype, attn_chunk=16)
    jflat, tflat = _cast(block_flat(kind, 35), dtype)
    rng = np.random.default_rng(36)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    gy = rng.standard_normal((2, 32, 64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    port, ref = _APPLY[kind]

    leaves = {k: v.requires_grad_(True) for k, v in tflat.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y, state = port(tree_unflatten(leaves), tx, cfg, mode="train")
    assert state is None and y.dtype == tdt
    grads = torch.autograd.grad(y, [tx, *leaves.values()], torch.from_numpy(gy).to(tdt))

    def jfn(x, params):
        out, st, _ = ref(tree_unflatten(params), x, jcfg, mode="train")
        assert st is None
        return out

    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jgy = jnp.asarray(gy).astype(jnp.dtype(dtype))
    def out_and_grads(x, params, gy):
        y, vjp = jax.vjp(jfn, x, params)
        return y, *vjp(gy)

    if dtype == "float32":  # jitted on the CPU, XLA drops bf16 roundings the port keeps
        out_and_grads = jax.jit(out_and_grads)

    jy, jgx, jgp = out_and_grads(jx, jflat, jgy)
    biases = [b for b in ("bi", "bf") if b in tflat]
    if biases:  # the per-position gradients: the biases broadcast over (B, S)
        wide = {k: (v.detach().expand(2, 32, cfg.n_heads).clone() if k in biases
                    else v.detach()).requires_grad_(k in biases) for k, v in tflat.items()}
        y_wide, _ = port(tree_unflatten(wide), tx.detach(), cfg, mode="train")
        terms = dict(zip(biases, torch.autograd.grad(
            y_wide, [wide[b] for b in biases], torch.from_numpy(gy).to(tdt))))
    _rel_close(y.float().detach().numpy(), np.asarray(jy, np.float32), tol, "y")
    _rel_close(grads[0].float().numpy(), np.asarray(jgx, np.float32), tol, "dx")
    for name, g in zip(leaves, grads[1:]):
        assert g.dtype == leaves[name].dtype, name
        got, want = g.float().numpy(), np.asarray(jgp[name], np.float32)
        if name in biases:
            bound = tol * terms[name].float().abs().sum(dim=(0, 1)).numpy()
            assert (np.abs(got - want) <= bound).all(), (name, got, want, bound)
        else:
            _rel_close(got, want, tol, name)


# --------------------------------------------------------------------------
# the tiny model: loss, every gradient, remat
# --------------------------------------------------------------------------

def _cfgs(**kw):
    return jget_tiny(ARCH).replace(**kw), get_tiny_config(ARCH).replace(**kw)


def _batch(seed, b=2, s=48, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.fixture(scope="module")
def jax_loss_grads():
    """The reference's jitted jax.value_and_grad(loss_fn) of the fp32 tiny
    model at attn_chunk 16 on a 2 x 48 batch (three mLSTM chunks), computed
    once for the module."""
    jcfg, _ = _cfgs(dtype="float32", attn_chunk=16)
    jparams, flat = model_params(jcfg, 2)
    batch = _batch(37)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return flat, batch, float(loss), float(parts["ce"]), _np_tree(grads)


def _port_loss_grads(cfg, flat, batch):
    params = params_from_numpy(flat, cfg, "cpu")
    leaves = [(p, t.requires_grad_(True)) for p, t in tree_flatten_with_paths(params)]
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, parts = steps.loss_fn(params, b, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, parts, {p: g for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_jax(jax_loss_grads, remat):
    """fp32: the loss and ce within 1e-6 and every one of the 31 gradient
    leaves within atol = rtol = 1e-5 of the reference's, across three mLSTM
    chunks, each leaf carrying a gradient."""
    flat, batch, jloss, jce, jgrads = jax_loss_grads
    _, cfg = _cfgs(dtype="float32", attn_chunk=16, remat=remat)
    loss, parts, grads = _port_loss_grads(cfg, flat, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(parts["ce"].item(), jce, rtol=1e-6)
    assert parts["aux"].item() == 0.0
    assert set(grads) == set(jgrads) and len(grads) == 31
    for path, g in grads.items():
        assert g.dtype == torch.float32
        assert float(np.abs(jgrads[path]).max()) > 0, path
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-5,
                                   err_msg=path)


def test_remat_does_not_change_gradients():
    """remat none, full and dots give bit-identical loss and gradients in the
    port's bf16 tiny xlstm (the training dtype): the recompute repeats the
    same arithmetic, the sLSTM's loop and the mLSTM's chunks included."""
    jcfg, _ = _cfgs(attn_chunk=16)
    _, flat = model_params(jcfg, 3)
    batch = _batch(38, s=32)
    results = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _cfgs(attn_chunk=16, remat=remat)
        results[remat] = _port_loss_grads(cfg, flat, batch)
    loss0, _, g0 = results["none"]
    for remat in ("full", "dots"):
        loss, _, g = results[remat]
        assert torch.equal(loss, loss0), remat
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)


# --------------------------------------------------------------------------
# train steps against the reference's jitted step
# --------------------------------------------------------------------------

N_STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20, eps=1e-6)  # as test_torch_archs_train


def _run_both(dtype):
    jcfg, cfg = _cfgs(dtype=dtype, attn_chunk=16)
    jparams, _ = model_params(jcfg, 4)
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    state = train_state_from_numpy(_np_tree(jstate), cfg, "cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**OPT)))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2, seed=5))
    jm, tm = [], []
    for i in range(N_STEPS):
        batch = data.batch_at(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, batch)
        jm.append({k: float(v) for k, v in jmet.items()})
        tm.append({k: float(v) for k, v in met.items()})
    return jstate, state, jm, tm


def test_train_steps_fp32_match_jax():
    """fp32: each step's loss, ce and grad norm within 1e-5 and the final
    params, master, m and v within 1e-5 of the reference's jitted
    make_train_step (two mLSTM chunks a sequence)."""
    jstate, state, jm, tm = _run_both("float32")
    for a, b in zip(tm, jm):
        for key in ("loss", "ce", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    assert int(state.step) == N_STEPS
    want = _np_tree(jstate)
    for path, got in tree_flatten_with_paths(state):
        np.testing.assert_allclose(got.detach().float().numpy(), want[path].astype(np.float32),
                                   atol=1e-5, rtol=1e-5, err_msg=path)


def test_train_steps_bf16_match_jax():
    """bf16 (the training dtype): each step's loss and grad norm within 2e-2
    and the final params within 2e-2, the tolerance the other archs' bf16
    steps are held to."""
    jstate, state, jm, tm = _run_both("bfloat16")
    for a, b in zip(tm, jm):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-2, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    want = _np_tree(jstate)
    for path, t in tree_flatten_with_paths(state.params):
        np.testing.assert_allclose(t.float().numpy(), want[f"params/{path}"].astype(np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=path)
    layer = state.params["blocks"]["layers"]
    assert layer[0]["out_norm"].dtype == torch.float32
    assert layer[1]["r"]["ri"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# checkpoints across packages
# --------------------------------------------------------------------------

def test_reference_train_state_restores_in_the_port_bit_for_bit(bucket):  # noqa: F811
    """An xlstm train state after a reference step (every leaf's moments off
    zero), saved by the reference, restores in the port bit for bit: the
    bare fp32 ``out_norm`` leaves, the 3-D recurrent weights and the rest."""
    jcfg, cfg = _cfgs()
    jparams = jsteps.init_params(jcfg, jax.random.key(3))
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    batch = {k: jnp.asarray(v) for k, v in _batch(2, s=32).items()}
    jstate, _ = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(warmup_steps=0)))(
        jstate, batch)
    jckpt.save(bucket, "ck", 1, jstate, {"loss": 1.5})
    flat, meta = ckpt.restore(bucket, "ck", 1)
    assert meta == {"loss": 1.5}
    want = dict(jflatten(jstate))
    assert set(flat) == set(want) and len(flat) == 1 + 4 * 31
    for path, t in flat.items():
        np.testing.assert_array_equal(_np_bits(t), _jnp_bits(want[path]), err_msg=path)
    state = train_state_from_numpy(flat, cfg, "cpu")
    assert int(state.step) == 1
    assert state.params["blocks"]["layers"][0]["out_norm"].dtype == torch.float32
    assert state.params["blocks"]["layers"][1]["r"]["rf"].shape == (2, 32, 32)
    assert bool((flat["opt/m/blocks/layers/0/bf"] != 0).any())  # the gate bias's gradient


def test_port_train_state_restores_in_the_reference_bit_for_bit(bucket):  # noqa: F811
    """A port xlstm train state after a port step restores in the reference
    bit for bit, against its abstract train state."""
    _, cfg = _cfgs()
    state = steps.init_train_state(cfg, 4)
    state, _ = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))(
        state, _batch(3, s=32))
    ckpt.save(bucket, "ck", 1, state, {"loss": 2.5})
    restored, meta = jckpt.restore(bucket, "ck", 1,
                                   like=jsteps.abstract_train_state(jget_tiny(ARCH)))
    assert meta == {"loss": 2.5}
    got = dict(jflatten(restored))
    assert set(got) == {p for p, _ in tree_flatten_with_paths(state)}
    for path, t in tree_flatten_with_paths(state):
        g = np.asarray(got[path])
        assert g.shape == tuple(t.shape) and str(g.dtype) == str(t.dtype).split(".")[-1], path
        np.testing.assert_array_equal(_jnp_bits(g), _np_bits(t), err_msg=path)


# --------------------------------------------------------------------------
# the train CLI's crash-resume, and the learner through the platform
# --------------------------------------------------------------------------

def test_train_cli_crash_resume_is_bit_equal(tmp_path, monkeypatch, capsys, one_thread):  # noqa: F811
    """``launch.train --arch xlstm-125m --tiny --device cpu``, 8 steps with
    checkpoints every 4: a run that crashes in step 6 (after its step-4
    checkpoint is written) and is started again with the same arguments
    resumes from step 4 and ends on the uninterrupted run's final
    checkpoint bit for bit."""
    base = ["--arch", ARCH, "--tiny", "--device", "cpu", "--batch", "2", "--seq", "16",
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
    assert "arch=xlstm-tiny" in out
    assert "resumed from checkpoint step 4" in out and "step     8 loss" in out
    assert int(state.step) == 8
    want, _ = ckpt.restore(DirBucket(str(tmp_path / "a")), "ckpt", 8)
    got, _ = ckpt.restore(crashed, "ckpt", 8)
    assert set(got) == set(want) and any(p.endswith("r/ri") for p in got)
    for path in want:
        assert got[path].dtype == want[path].dtype and torch.equal(got[path], want[path]), path


def _run_xlstm_job(crash_at_step=None):
    """An xlstm tiny job of 20 steps, checkpoints every 10, through the
    platform; with ``crash_at_step`` its learner's runtime is killed and its
    pod failed once the job reaches that step. Returns (final step, final
    checkpoint leaves, its metadata, whether it crashed)."""
    p = FfDLPlatform(n_hosts=2, chips_per_host=4)
    c = ApiClient.for_platform(p)
    j = c.submit(JobManifest(
        name="xlstm", arch=ARCH, n_learners=1, chips_per_learner=2,
        checkpoint_interval=10, train={"steps": 20, "batch": 2, "seq": 16, "seed": 5}))
    crashed = False
    for _ in range(3000):
        p.tick()
        rec = p.meta.get(j)
        if rec.status in (JobStatus.COMPLETED, JobStatus.FAILED):
            break
        if (crash_at_step is not None and not crashed
                and rec.status == JobStatus.PROCESSING
                and rec.progress_step >= crash_at_step):
            g = p.guardians[j]
            g.runtimes[0].kill()
            p.cluster.fail_pod(g.pods[0].name)
            crashed = True
    assert c.status(j) == JobStatus.COMPLETED
    bucket = MountedBucket(p.objstore, "results")
    final = ckpt.latest_step(bucket, f"{j}/ckpt")
    leaves, meta = ckpt.restore(bucket, f"{j}/ckpt", final)
    return final, leaves, meta, crashed


def test_learner_crash_resume_of_an_xlstm_job_is_bit_equal(torch_learners):  # noqa: F811
    """``TorchLearner`` on an xlstm tiny job through the platform: killed at
    step 15 of 20, restarted by the guardian, resumed from the step-10
    checkpoint, it ends on params, optimizer state and step equal bit for
    bit to the uninterrupted job's."""
    built = torch_learners("cpu")
    step_a, leaves_a, _, _ = _run_xlstm_job()
    n_uninterrupted = len(built)
    step_b, leaves_b, meta, crashed = _run_xlstm_job(crash_at_step=15)
    assert crashed and len(built) == n_uninterrupted + 2  # the crashed one, its restart
    assert built[-1].cfg.pattern_for_layers() == ("mlstm", "slstm")
    assert step_a == step_b == 20 and meta == {"final": True}
    assert built[-1].loss_history[0][0] >= 10  # the restart resumed, not restarted
    assert set(leaves_a) == set(leaves_b) and any(p.endswith("out_norm") for p in leaves_a)
    for path in leaves_a:
        assert leaves_a[path].dtype == leaves_b[path].dtype
        assert torch.equal(leaves_a[path], leaves_b[path]), path


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_xlstm_tiny_step_on_card_is_deterministic_and_matches_the_cpu():
    """On the card, under deterministic algorithms (``launch.train.
    deterministic``, which raises on ``torch.cumsum`` of a float CUDA tensor
    among others): a tiny xlstm step at attn_chunk 16 (four mLSTM chunks),
    run twice from the same weights, ends on the same state bit for bit;
    in fp32 its loss is within 1e-5 and its grad norm within 1e-4 of the
    same step on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py trains xlstm-125m at full width)")
    from repro_torch.launch.train import deterministic

    deterministic(torch.device("cuda"))
    batch = SyntheticLM(DataConfig(256, 64, 4, seed=1)).batch_at(0)
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = get_tiny_config(ARCH).replace(dtype=dtype, attn_chunk=16)
        runs = []
        for device in ("cuda", "cuda", "cpu"):
            state = steps.init_train_state(cfg, 0, device)
            state, met = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))(state, batch)
            runs.append(({k: float(v) for k, v in met.items()},
                         [t.cpu() for _, t in tree_flatten_with_paths(state)]))
        (a, sa), (b, sb), (cpu, _) = runs
        assert a == b and all(torch.equal(x, y) for x, y in zip(sa, sb))
        out[dtype] = (a, cpu)
    card, cpu = out["float32"]
    assert abs(card["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])
    assert abs(card["grad_norm"] - cpu["grad_norm"]) <= 1e-4 * abs(cpu["grad_norm"])
