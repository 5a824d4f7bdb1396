"""The port's whisper-tiny training slice against the JAX package, on the
CPU, at the tiny config: the loss and every fp32 gradient leaf, train steps,
train states across packages, and the train CLI, which cannot train whisper
in either package (its synthetic stream has no frames).

Weights: ``test_torch_whisper.model_params`` (the reference's init, the
norms redrawn, the attention projections at their true fan-in). A batch is
tokens, labels and frames, as the reference's arch smoke test builds it,
drawn with numpy from fixed seeds. Tolerances: the fp32 loss within 1e-6 and
gradients within atol = rtol = 1e-5; three steps against the reference's
jitted step, fp32 within 1e-5, bf16 within 2e-2.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_recurrent_train import _jnp_bits, _np_bits, _np_tree
from test_torch_recurrent_train import bucket  # noqa: F401 (a fixture)
from test_torch_whisper import model_params

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_tiny_config as jget_tiny
from repro.launch import train as jtrain_cli
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_tiny_config
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import steps
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths

ARCH = "whisper-tiny"
N_STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20, eps=1e-6)  # as test_torch_archs_train
N_LEAVES = 57  # the tiny config's: 2 encoder and 2 decoder layers


def _cfgs(**kw):
    return jget_tiny(ARCH).replace(**kw), get_tiny_config(ARCH).replace(**kw)


def _frames_np(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels, "frames": _frames_np(cfg, b, seed + 1)}


def _jbatch(batch, dtype):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["frames"] = out["frames"].astype(jnp.dtype(dtype))
    return out


def _tbatch(batch, dtype):
    out = dict(batch)
    out["frames"] = torch.from_numpy(batch["frames"]).to(getattr(torch, dtype))
    return out


# --------------------------------------------------------------------------
# the loss and every gradient
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_grads():
    """The reference's jitted jax.value_and_grad(loss_fn) of the fp32 tiny
    model on a 2 x 16 batch with 2 x 32 fp32 frames, computed once."""
    jcfg, _ = _cfgs(dtype="float32")
    jparams, flat = model_params(jcfg, 10)
    batch = _batch(jcfg, 11)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(jparams, _jbatch(batch, "float32"))
    return flat, batch, float(loss), float(parts["ce"]), _np_tree(grads)


def test_loss_and_grads_match_jax(jax_loss_grads):
    """fp32: the loss and ce within 1e-6, aux 0, and every one of the 57
    gradient leaves (the LayerNorm scales and biases, the self- and
    cross-attention projections, the GELU MLPs, the tied embedding) within
    atol = rtol = 1e-5 of the reference's, each carrying a gradient. The
    encoder-decoder has no remat in either package."""
    flat, batch, jloss, jce, jgrads = jax_loss_grads
    _, cfg = _cfgs(dtype="float32")
    params = params_from_numpy(flat, cfg, "cpu")
    leaves = [(p, t.requires_grad_(True)) for p, t in tree_flatten_with_paths(params)]
    loss, parts = steps.loss_fn(params, steps._batch_on(_tbatch(batch, "float32"), "cpu"), cfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
    np.testing.assert_allclose(parts["ce"].item(), jce, rtol=1e-6)
    assert parts["aux"].item() == 0.0
    assert set(jgrads) == {p for p, _ in leaves} and len(jgrads) == N_LEAVES
    for (path, _), g in zip(leaves, grads):
        assert g.dtype == torch.float32
        assert float(np.abs(jgrads[path]).max()) > 0, path
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-5, err_msg=path)


def test_batch_on_keeps_frames_floating():
    """Tokens and labels become int64; frames keep their floating dtype."""
    _, cfg = _cfgs()
    out = steps._batch_on(_tbatch(_batch(cfg, 3), "bfloat16"), "cpu")
    assert out["tokens"].dtype == out["labels"].dtype == torch.int64
    assert out["frames"].dtype == torch.bfloat16
    out = steps._batch_on(_batch(cfg, 3), "cpu")
    assert out["frames"].dtype == torch.float32
    assert torch.equal(out["frames"], torch.from_numpy(_batch(cfg, 3)["frames"]))


def test_eval_step_matches_the_loss():
    _, cfg = _cfgs(dtype="float32")
    params = steps.init_params(cfg, 2)
    batch = _batch(cfg, 4)
    got = steps.make_eval_step(cfg)(params, batch)
    with torch.no_grad():
        loss, _ = steps.loss_fn(params, steps._batch_on(batch, "cpu"), cfg)
    assert torch.equal(got["loss"], loss) and got["aux"].item() == 0.0


# --------------------------------------------------------------------------
# train steps against the reference's jitted step
# --------------------------------------------------------------------------

def _run_both(dtype):
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams, _ = model_params(jcfg, 12)
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    state = train_state_from_numpy(_np_tree(jstate), cfg, "cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**OPT)))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, seed=5))
    jm, tm = [], []
    for i in range(N_STEPS):
        batch = dict(data.batch_at(i), frames=_frames_np(cfg, 2, 20 + i))
        jstate, jmet = jstep(jstate, _jbatch(batch, dtype))
        state, met = step(state, _tbatch(batch, dtype))
        jm.append({k: float(v) for k, v in jmet.items()})
        tm.append({k: float(v) for k, v in met.items()})
    return jstate, state, jm, tm


def test_train_steps_fp32_match_jax():
    """fp32: each step's loss, ce and grad norm within 1e-5 and the final
    params, master, m and v within 1e-5 of the reference's jitted
    make_train_step."""
    jstate, state, jm, tm = _run_both("float32")
    for a, b in zip(tm, jm):
        for key in ("loss", "ce", "aux", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    assert int(state.step) == N_STEPS
    want = _np_tree(jstate)
    for path, got in tree_flatten_with_paths(state):
        np.testing.assert_allclose(got.detach().float().numpy(), want[path].astype(np.float32),
                                   atol=1e-5, rtol=1e-5, err_msg=path)


def test_train_steps_bf16_match_jax():
    """bf16 (the training dtype, bf16 frames): each step's loss and grad norm
    within 2e-2 and the final params within 2e-2, the tolerance the other
    archs' bf16 steps are held to; the LayerNorm leaves stay fp32."""
    jstate, state, jm, tm = _run_both("bfloat16")
    for a, b in zip(tm, jm):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-2, err_msg=key)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    want = _np_tree(jstate)
    for path, t in tree_flatten_with_paths(state.params):
        np.testing.assert_allclose(t.float().numpy(), want[f"params/{path}"].astype(np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=path)
    assert state.params["enc"][0]["norm1"]["bias"].dtype == torch.float32
    assert state.params["dec"][1]["cross"]["wk"].dtype == torch.bfloat16


def test_train_steps_repeat_bit_for_bit_and_launch_nothing_on_the_cpu():
    """Two runs of two bf16 steps from the same seed end on the same state
    bit for bit; on the CPU the flash dispatch takes its plain version."""
    _, cfg = _cfgs()
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))
    ends = []
    ops.reset_launch_counts()
    for _ in range(2):
        state = steps.init_train_state(cfg, 7)
        for i in range(2):
            state, _ = step(state, _tbatch(_batch(cfg, 30 + i), "bfloat16"))
        ends.append(tree_flatten_with_paths(state))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(*ends))
    assert ops.launch_counts()["flash_attention"] == 0


# --------------------------------------------------------------------------
# checkpoints across packages
# --------------------------------------------------------------------------

def test_reference_train_state_restores_in_the_port_bit_for_bit(bucket):  # noqa: F811
    """A whisper train state after a reference step, saved by the reference,
    restores in the port bit for bit, the fp32 LayerNorm biases and their
    moments included."""
    jcfg, cfg = _cfgs()
    jparams = jsteps.init_params(jcfg, jax.random.key(3))
    jstate = jsteps.TrainState(jnp.zeros((), jnp.int32), jparams, jadamw.init(jparams))
    jstate, _ = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(warmup_steps=0)))(
        jstate, _jbatch(_batch(jcfg, 2), "bfloat16"))
    jckpt.save(bucket, "ck", 1, jstate, {"loss": 1.5})
    flat, meta = ckpt.restore(bucket, "ck", 1)
    assert meta == {"loss": 1.5}
    want = dict(jflatten(jstate))
    assert set(flat) == set(want) and len(flat) == 1 + 4 * N_LEAVES
    for path, t in flat.items():
        np.testing.assert_array_equal(_np_bits(t), _jnp_bits(want[path]), err_msg=path)
    state = train_state_from_numpy(flat, cfg, "cpu")
    assert int(state.step) == 1
    assert state.params["enc_norm"]["bias"].dtype == torch.float32
    assert bool((flat["opt/m/dec/0/norm_cross/bias"] != 0).any())


def test_port_train_state_restores_in_the_reference_bit_for_bit(bucket):  # noqa: F811
    """A port whisper train state after a port step restores in the reference
    bit for bit, against its abstract train state."""
    _, cfg = _cfgs()
    state = steps.init_train_state(cfg, 4)
    state, _ = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))(
        state, _tbatch(_batch(cfg, 3), "bfloat16"))
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
# the train CLI
# --------------------------------------------------------------------------

def test_train_cli_fails_on_frames_as_the_reference(monkeypatch, tmp_path):
    """``launch.train --arch whisper-tiny`` fails at its first step with
    KeyError: 'frames' in both packages: the synthetic token stream yields
    no frames, and neither package invents a frames source for it."""
    args = ["--arch", ARCH, "--tiny", "--steps", "2", "--batch", "2", "--seq", "16"]
    with pytest.raises(KeyError, match="frames"):
        train_cli.main(args + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["train"] + args + ["--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(KeyError, match="frames"):
        jtrain_cli.main()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_whisper_tiny_step_on_card_is_deterministic_and_matches_the_cpu():
    """On the card, under deterministic algorithms: a tiny whisper step (2
    bidirectional encoder and 2 causal decoder flash launches forward, as
    many backward) run twice from the same weights ends on the same state
    bit for bit; in fp32 its loss is within 1e-6 and its grad norm within
    1e-5 of the same step on the CPU. The weights are ``model_params``'s,
    at their true fan-in: on the default init (ROADMAP C.9) attention is
    nearly one-hot, and there the card's fp32 grad norm parted from the
    CPU's by 6.4e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py trains whisper-tiny at full width)")
    from repro_torch.launch.train import deterministic

    deterministic(torch.device("cuda"))
    base = _batch(get_tiny_config(ARCH), 40, b=4, s=32)
    for dtype in ("bfloat16", "float32"):
        jcfg, cfg = _cfgs(dtype=dtype)
        _, flat = model_params(jcfg, 0)
        runs = []
        for device in ("cuda", "cuda", "cpu"):
            params = params_from_numpy(flat, cfg, device)
            state = steps.TrainState(torch.zeros((), dtype=torch.int32, device=device), params,
                                     adamw.init(params))
            ops.reset_launch_counts()
            state, met = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))(
                state, _tbatch(base, dtype))
            runs.append(({k: float(v) for k, v in met.items()}, ops.launch_counts(),
                         [t.cpu() for _, t in tree_flatten_with_paths(state)]))
        (m0, n0, s0), (m1, _, s1), (mc, _, _) = runs
        assert n0["flash_attention"] == 4 and n0["flash_attention_bwd"] == 4
        assert all(torch.equal(a, b) for a, b in zip(s0, s1)) and m0 == m1
        if dtype == "float32":
            assert abs(m0["loss"] - mc["loss"]) <= 1e-6 * abs(mc["loss"])
            assert abs(m0["grad_norm"] - mc["grad_norm"]) <= 1e-5 * abs(mc["grad_norm"])
