"""Checkpoints and crash-resume of the decoder-only attention archs'
training in the port, on the CPU: qwen2.5-3b's and granite-moe-3b-a800m's
train states (QKV biases, the MoE's fp32 router and stacked experts)
restored across packages bit for bit, the train CLI's crash-resume and
``TorchLearner`` killed and resumed through the platform on a granite job,
and ``chip_smoke.routing``, which pins an MoE path's routing to another
path's choices on the card.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_learner import torch_learners  # noqa: F401 (a fixture)
from test_torch_recurrent_train import _Crash, _jnp_bits, _np_bits
from test_torch_recurrent_train import bucket  # noqa: F401 (a fixture)

import chip_smoke
from repro.api import ApiClient
from repro.ckpt import checkpoint as jckpt
from repro.configs import get_tiny_config as jget_tiny
from repro.core import FfDLPlatform, JobManifest, JobStatus
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_tiny_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.objectstore import DirBucket, MountedBucket
from repro_torch.launch import train as train_cli
from repro_torch.models import lm, steps
from repro_torch.nn import moe
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

GRANITE = "granite-moe-3b-a800m"
CKPT_ARCHS = ["qwen2.5-3b", GRANITE]


def _batch(seed, b=2, s=32, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


# --------------------------------------------------------------------------
# checkpoints across packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_reference_train_state_restores_in_the_port_bit_for_bit(bucket, arch):  # noqa: F811
    """A train state after a reference step (the optimizer's moments of
    every leaf off zero, the zero-init biases' too), saved by the reference,
    restores in the port bit for bit, the router and norm scales fp32, the
    rest bf16."""
    jcfg, cfg = jget_tiny(arch), get_tiny_config(arch)
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
    layer = state.params["blocks"]["layers"][1]
    if cfg.qkv_bias:
        assert layer["attn"]["bq"].dtype == torch.bfloat16
        assert bool((flat["opt/m/blocks/layers/1/attn/bq"] != 0).any())  # the bias's gradient
    if cfg.is_moe:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["down"].shape == (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_port_train_state_restores_in_the_reference_bit_for_bit(bucket, arch):  # noqa: F811
    """A port train state after a port step restores in the reference bit
    for bit, against its abstract train state."""
    cfg = get_tiny_config(arch)
    state = steps.init_train_state(cfg, 4)
    state, _ = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))(state, _batch(3))
    ckpt.save(bucket, "ck", 1, state, {"loss": 2.5})
    restored, meta = jckpt.restore(bucket, "ck", 1,
                                   like=jsteps.abstract_train_state(jget_tiny(arch)))
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

def test_train_cli_crash_resume_is_bit_equal(tmp_path, monkeypatch, capsys):
    """``launch.train --arch granite-moe-3b-a800m --tiny --device cpu``, 8
    steps with checkpoints every 4: a run that crashes in step 6 (after its
    step-4 checkpoint is written) and is started again with the same
    arguments resumes from step 4 and ends on the uninterrupted run's final
    checkpoint bit for bit, the MoE's leaves and optimizer state among it."""
    base = ["--arch", GRANITE, "--tiny", "--device", "cpu", "--batch", "2", "--seq", "32",
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
    assert "arch=granite-moe-tiny" in out
    assert "resumed from checkpoint step 4" in out and "step     8 loss" in out
    assert int(state.step) == 8
    want, _ = ckpt.restore(DirBucket(str(tmp_path / "a")), "ckpt", 8)
    got, _ = ckpt.restore(crashed, "ckpt", 8)
    assert set(got) == set(want) and any(p.endswith("moe/router") for p in got)
    for path in want:
        assert got[path].dtype == want[path].dtype and torch.equal(got[path], want[path]), path


def _run_granite_job(crash_at_step=None):
    """A granite tiny job of 40 steps, checkpoints every 10, through the
    platform; with ``crash_at_step`` its learner's runtime is killed and its
    pod failed once the job reaches that step. Returns (final step, final
    checkpoint leaves, its metadata, whether it crashed)."""
    p = FfDLPlatform(n_hosts=2, chips_per_host=4)
    c = ApiClient.for_platform(p)
    j = c.submit(JobManifest(
        name="moe", arch=GRANITE, n_learners=1, chips_per_learner=2,
        checkpoint_interval=10,
        train={"steps": 40, "batch": 2, "seq": 32, "seed": 5}))
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


def test_learner_crash_resume_of_an_moe_job_is_bit_equal(torch_learners):  # noqa: F811
    """``TorchLearner`` on a granite tiny job through the platform: killed
    at step 25 of 40, restarted by the guardian, resumed from the step-20
    checkpoint, it ends on params, optimizer state and step equal bit for
    bit to the uninterrupted job's."""
    built = torch_learners("cpu")
    step_a, leaves_a, _, _ = _run_granite_job()
    n_uninterrupted = len(built)
    step_b, leaves_b, meta, crashed = _run_granite_job(crash_at_step=25)
    assert crashed and len(built) == n_uninterrupted + 2  # the crashed one, its restart
    assert built[-1].cfg.is_moe
    assert step_a == step_b == 40 and meta == {"final": True}
    assert built[-1].loss_history[0][0] >= 20  # the restart resumed, not restarted
    assert set(leaves_a) == set(leaves_b) and any(p.endswith("moe/up") for p in leaves_a)
    for path in leaves_a:
        assert leaves_a[path].dtype == leaves_b[path].dtype
        assert torch.equal(leaves_a[path], leaves_b[path]), path


# --------------------------------------------------------------------------
# chip_smoke.routing: pinning a path's routing to another's choices
# --------------------------------------------------------------------------

def test_routing_pinned_to_a_steps_own_choices_repeats_it_bit_for_bit():
    """A granite tiny train step (remat full: each router runs in the
    forward and again in the backward) recorded by ``routing(record=...)``,
    then the same step from the same state with its routing pinned to that
    record: the metrics and the new state are the same bits, and the
    choices the pinned step would have made are the recorded ones. The
    record's gaps carry no autograd graph (one would keep the recorded
    step's activations alive on the card)."""
    cfg = get_tiny_config(GRANITE)
    opt = adamw.AdamWConfig(warmup_steps=0)
    batch = _batch(5)
    record, own = [], []
    with chip_smoke.routing(record=record):
        free, free_met = steps.make_train_step(cfg, opt)(steps.init_train_state(cfg, 1), batch)
    assert len(record) == 2 * cfg.n_layers
    # no autograd graph in the record: it would hold the step's activations
    assert not any(gap.requires_grad for _, gap in record)
    with chip_smoke.routing(pinned=[c for c, _ in record], own=own):
        held, held_met = steps.make_train_step(cfg, opt)(steps.init_train_state(cfg, 1), batch)
    assert all(torch.equal(a, c) for a, (c, _) in zip(own, record, strict=True))
    assert free_met.keys() == held_met.keys()
    assert all(torch.equal(free_met[k], held_met[k]) for k in free_met)
    for (path, x), (_, y) in zip(tree_flatten_with_paths(free), tree_flatten_with_paths(held)):
        assert torch.equal(x, y), path


def test_routing_pinned_to_other_choices_takes_their_aux():
    """Pinned to choices other than its own, a granite tiny forward's aux is
    the load-balancing loss of the pinned top choices under the path's own
    probabilities (not the aux of the choices it would have made), and
    gradients reach the router through the pinned weights and that aux."""
    cfg = get_tiny_config(GRANITE).replace(dtype="float32", remat="none")  # a router call a layer
    params = steps.init_params(cfg, 2)
    tokens = torch.from_numpy(_batch(6)["tokens"]).long()
    inputs, router_topk = [], moe.router_topk

    def spy(p_router, x, top_k):
        inputs.append((p_router, x))
        return router_topk(p_router, x, top_k)

    moe.router_topk = spy
    try:
        _, free_aux = lm.lm_apply(params, tokens, cfg, mode="train")
    finally:
        moe.router_topk = router_topk
    pins = [(router_topk(p, x, cfg.top_k)[1] + 1) % cfg.n_experts for p, x in inputs]
    router = params["blocks"]["layers"][0]["moe"]["router"].requires_grad_(True)
    inputs.clear()
    moe.router_topk = spy  # the pinned run's router inputs, to reckon its aux from
    try:
        with chip_smoke.routing(pinned=pins, own=[]):
            _, aux = lm.lm_apply(params, tokens, cfg, mode="train")
    finally:
        moe.router_topk = router_topk
    want = 0.0
    for (p_router, x), pin in zip(inputs, pins, strict=True):
        probs = torch.softmax(x.float() @ p_router, dim=-1)
        top = torch.nn.functional.one_hot(pin[:, 0], cfg.n_experts).float()
        want = want + cfg.n_experts * (top.mean(0) * probs.mean(0)).mean()
    torch.testing.assert_close(aux, want.detach(), rtol=1e-6, atol=0)
    assert abs(aux.item() - free_aux.item()) > 1e-3
    (g,) = torch.autograd.grad(aux, [router])
    assert g.abs().max() > 0


def test_a_train_state_dies_with_its_last_reference():
    """With the cyclic garbage collector off, a granite tiny train state is
    freed as soon as its last reference goes: no reference cycle (such as a
    self-calling closure in ``tree_flatten_with_paths``, which the step and
    AdamW call) holds its leaves. On the card a full-width state fills half
    the device, and a second one is built right after the first is dropped."""
    cfg = get_tiny_config(GRANITE)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))
    state, _ = step(steps.init_train_state(cfg, 1), _batch(7))  # first-call set-up
    del state
    gc.collect()
    gc.disable()
    try:
        state, metrics = step(steps.init_train_state(cfg, 1), _batch(7))
        leaves = [weakref.ref(t) for _, t in tree_flatten_with_paths(state)]
        del state, metrics
        assert not any(r() is not None for r in leaves)
    finally:
        gc.enable()


@pytest.mark.parametrize("piece", [1000, 3000])
def test_donated_update_in_pieces_equals_the_functional_update(monkeypatch, piece):
    """The donated AdamW update splits each leaf into pieces of at most
    ``adamw.DONATE_PIECE`` elements (so only one piece's fp32 temporaries
    live on the card); with pieces smaller than most leaves of a granite
    tiny train state (ragged ones among them), two steps give the state that
    the functional update gives from the same gradients, bit for bit."""
    monkeypatch.setattr(adamw, "DONATE_PIECE", piece)
    cfg = get_tiny_config(GRANITE)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    a, b = steps.init_train_state(cfg, 3), steps.init_train_state(cfg, 3)
    assert any(t.numel() > piece and t.numel() % piece for _, t in tree_flatten_with_paths(a))
    for i in range(2):
        batch = {k: torch.from_numpy(v).long() for k, v in _batch(10 + i).items()}
        flat = tree_flatten_with_paths(a.params)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        params = {p: t for (p, _), t in zip(flat, leaves)}
        loss, _ = steps.loss_fn(tree_unflatten(params), batch, cfg)
        grads = tree_unflatten(dict(zip(params, torch.autograd.grad(loss, leaves))))
        new_params, new_opt, _ = adamw.update(opt, grads, a.opt, a.step)
        a = steps.TrainState(a.step + 1, new_params, new_opt)
        embed = b.params["embed"]
        b, _ = steps.make_train_step(cfg, opt)(b, batch)
        assert b.params["embed"] is embed  # donated: updated where it lay
    for (path, x), (_, y) in zip(tree_flatten_with_paths(a), tree_flatten_with_paths(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), path
