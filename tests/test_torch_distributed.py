"""The port on a mesh, in gloo processes on the CPU, against its unsharded
runs and the JAX package.

One spawn of four ranks (``tests/_torch_dist_worker.py``) runs every case
on its own mesh over the same world, each rank saving what it saw; the
spawn is bounded by a timeout that kills the ranks and fails, and its store
is a ``file://`` path under the test's tmp dir. The cases:

1. qwen2.5-tiny, 2 train steps on 2x2: bf16 losses within the reference's
   own tolerances (``tests/test_sharding.py``: rtol 2e-4 on the first, 4e-3
   on the second), fp32 params within 1e-5 of the port's unsharded run, and
   every rank's local shapes of the params and of m/v/master equal to the
   reference's ``NamedSharding.shard_shape``;
2. the same on 1x4, where q's 4 heads shard and the 2 kv heads do not:
   fp32 logits within 1e-5, the flash dispatch seeing q split on heads and
   kv whole; and on 2x2 with ``--sp``'s and ``--batch-tp``'s overrides
   (the residual's sequence over ``model``; attention's batch over both
   axes), fp32 params within 1e-5;
3. the MoE's branches, qwen3-moe-tiny (8 experts over model 2: expert-
   parallel) and granite-tiny (5 experts: token-parallel): y and aux held to
   the reference's ``moe_ffn_local`` applied per shard and combined as its
   ``shard_map`` branches combine them, and the whole model's gradients
   held to the port's unsharded loss with its MoE computed per shard alike;
4. recurrentgemma-tiny with the scan split over ``lru``: fp32 prefill
   logits within 1e-5; and 2 fp32 train steps on 2x2 with ``--sp``, the
   scan's input gathered on time, params within 1e-5;
5. elastic restore of smollm-tiny from 2x2 to 4x1, within rtol 2e-3 of the
   run that stayed (``tests/test_sharding.py``), its checkpoint read by the
   reference's ``restore(like=abstract_train_state)``;
6. the train CLI on 2x2: 6 steps, and a run crashed in step 5 and resumed,
   end on the same checkpoint bit for bit;
7. ``ServeEngine`` on 2x2 with and without ctx_parallel (and recurrentgemma
   with its one kv head's cache split on kv_seq, and qwen2.5 on 1x4, q's
   heads split while the cache splits on kv_seq): 6 greedy fp32 tokens
   equal the unsharded engine's;
8. the kernels' dispatchers given a split they cannot run on local shards,
   a partial placement or a plain tensor beside DTensors: they raise.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker as W
from repro.ckpt import checkpoint as jckpt
from repro.configs import get_tiny_config as jget_tiny
from repro.data.objectstore import DirBucket as JDirBucket
from repro.models import steps as jsteps
from repro.nn import moe as jmoe
from repro.parallel import param_shardings as jparam_shardings
from repro.parallel.zero import opt_state_shardings as jopt_state_shardings
from repro.launch.mesh import make_env as jmake_env

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.objectstore import DirBucket
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm, steps
from repro_torch.nn import blocks
from repro_torch.nn.moe import moe_ffn_local
from repro_torch.optim import adamw
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

WORLD = 4
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results, one dict per rank, and the ranks' output dir."""
    out = tmp_path_factory.mktemp("dist")
    ctx = mp.start_processes(W.run, args=(WORLD, str(out / "store"), str(out), list(W.CASES)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:  # join() returns at each rank's exit: True once all have
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return results, out


def _case(ranks, name):
    results, _ = ranks
    for r in results:
        assert name in r, f"{name}: a rank stopped before it"
        assert "error" not in r[name], r[name].get("error")
    return [r[name] for r in results]


def _unsharded_train(arch, dtype, n_steps=2):
    cfg = W.tiny(arch, dtype)
    st = steps.init_train_state(cfg, 0)
    ts = steps.make_train_step(cfg, adamw.AdamWConfig(**W.OPT))
    losses = []
    for i in range(n_steps):
        st, m = ts(st, W.batch_at(cfg, i))
        losses.append(float(m["loss"]))
    return losses, {p: t.float().numpy() for p, t in tree_flatten_with_paths(st.params)}


def _ref_shard_shapes(arch, shape):
    """{part: {path: local shape}} under the reference's shardings."""
    env = jmake_env(jax.sharding.AbstractMesh(shape, ("data", "model")))
    cfg = jget_tiny(arch)
    ap, axes = jsteps.abstract_params(cfg), jsteps.param_axes(cfg)
    out = {}
    for part, tree in (("params", jparam_shardings(axes, ap, env)),
                       ("m", jopt_state_shardings(axes, ap, env).m)):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
        shapes = {jax.tree_util.keystr(p): a.shape
                  for p, a in jax.tree_util.tree_flatten_with_path(ap)[0]}
        out[part] = {_path(p): s.shard_shape(shapes[jax.tree_util.keystr(p)]) for p, s in flat}
    out["v"] = out["master"] = out["m"]
    return out


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)


# --------------------------------------------------------------------------
# 1, 2: dense training on 2x2 and 1x4
# --------------------------------------------------------------------------

def test_qwen_2x2_bf16_losses(ranks):
    got = _case(ranks, "qwen_2x2_bf16")
    want, _ = _unsharded_train("qwen2.5-3b", "bfloat16")
    np.testing.assert_allclose(got[0]["losses"][0], want[0], rtol=2e-4)
    np.testing.assert_allclose(got[0]["losses"][1], want[1], rtol=4e-3)
    assert all(r["losses"] == got[0]["losses"] for r in got)  # one loss on every rank


@pytest.mark.parametrize("case", ["qwen_2x2_fp32", "qwen_1x4_fp32", "qwen_2x2_sp_fp32",
                                  "qwen_2x2_batch_tp_fp32"])
def test_qwen_fp32_params_within_1e5(ranks, case):
    got = _case(ranks, case)
    _, want = _unsharded_train("qwen2.5-3b", "float32")
    assert set(got[0]["params"]) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[0]["params"][path], w, atol=1e-5, rtol=0, err_msg=path)


@pytest.mark.parametrize("case,shape", [("qwen_2x2_bf16", (2, 2)), ("qwen_2x2_fp32", (2, 2)),
                                        ("qwen_1x4_fp32", (1, 4))])
def test_local_shapes_equal_reference_shard_shapes(ranks, case, shape):
    want = _ref_shard_shapes("qwen2.5-3b", shape)
    for r in _case(ranks, case):
        for part in ("params", "m", "v", "master"):
            assert r["shapes"][part] == want[part], part


def test_gqa_1x4_q_heads_split_kv_whole(ranks):
    got = _case(ranks, "qwen_1x4_fp32")
    cfg = W.tiny("qwen2.5-3b", "float32")
    with torch.no_grad():
        want, _ = lm.lm_apply(steps.init_params(cfg, 0),
                              torch.as_tensor(W.batch_at(cfg, 0)["tokens"]).long(), cfg,
                              mode="prefill")
    np.testing.assert_allclose(got[0]["logits"], want.numpy(), atol=1e-5, rtol=0)
    q, k, v = got[0]["flash"][0]
    assert q == ("R", "S(1)") and k == v == ("R", "R")


# --------------------------------------------------------------------------
# 3: the MoE's expert- and token-parallel branches
# --------------------------------------------------------------------------

def _moe_inputs(arch):
    cfg = W.tiny(arch, "float32")
    params = steps.init_params(cfg, 0)
    x = torch.randn((W.B, W.S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    return cfg, params, x


def _ref_moe_per_shard(cfg, p, x, n_dp, n_model, token_parallel):
    """The reference's moe_ffn_local on each shard, combined as its
    shard_map branches combine them (moe.py: the token-parallel branch's
    pmean of aux over DP and model; the expert-parallel branch's psum of y
    and pmean of aux over model, then pmean over DP)."""
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, act=cfg.act)
    b, s, d = x.shape
    ys, auxes = [], []
    for xb in np.split(x.numpy(), n_dp, axis=0):
        if token_parallel:
            parts = []
            for xs in np.split(xb, n_model, axis=1):
                y, aux = jmoe.moe_ffn_local(jp, jnp.asarray(xs.reshape(-1, d)), **kw)
                parts.append(np.asarray(y).reshape(xs.shape))
                auxes.append(float(aux))
            ys.append(np.concatenate(parts, axis=1))
        else:
            e_local = cfg.n_experts // n_model
            y_sum, aux_m = 0.0, []
            for m in range(n_model):
                pm = dict(jp, **{k: jp[k][m * e_local:(m + 1) * e_local]
                                 for k in ("up", "gate", "down")})
                y, aux = jmoe.moe_ffn_local(pm, jnp.asarray(xb.reshape(-1, d)), e_start=m * e_local,
                                            e_local=e_local, **kw)
                y_sum = y_sum + np.asarray(y)
                aux_m.append(float(aux))
            ys.append(y_sum.reshape(xb.shape))
            auxes.append(np.mean(aux_m))
    return np.concatenate(ys, axis=0), float(np.mean(auxes))


def _moe_per_shard(n_dp, n_model, token_parallel):
    """The port's unsharded moe_ffn, computed per shard as the mesh does."""
    def moe_ffn(p, x, *, top_k, capacity_factor=1.25, act="silu"):
        b, s, d = x.shape
        ys, auxes = [], []
        for xb in x.chunk(n_dp, dim=0):
            chunks = xb.chunk(n_model, dim=1) if token_parallel else [xb]
            parts = []
            for xs in chunks:
                y, aux = moe_ffn_local(p, xs.reshape(-1, d), top_k=top_k,
                                       capacity_factor=capacity_factor, act=act)
                parts.append(y.reshape(xs.shape))
                auxes.append(aux)
            ys.append(torch.cat(parts, dim=1))
        return torch.cat(ys, dim=0), torch.stack(auxes).mean()
    return moe_ffn


@pytest.mark.parametrize("case,arch,branch", [
    ("moe_qwen3", "qwen3-moe-235b-a22b", (2, False)),
    ("moe_granite", "granite-moe-3b-a800m", (1, True))])
def test_moe_branch_matches_reference_per_shard(ranks, case, arch, branch, monkeypatch):
    got = _case(ranks, case)
    assert tuple(got[0]["branch"]) == branch
    cfg, params, x = _moe_inputs(arch)
    token_parallel = branch[1]
    y, aux = _ref_moe_per_shard(cfg, params["blocks"]["layers"][0]["moe"], x, 2, 2,
                                token_parallel)
    np.testing.assert_allclose(got[0]["y"], y, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[0]["aux"], aux, atol=1e-6, rtol=1e-6)

    # the whole model's gradients against the port's unsharded loss with its
    # MoE computed per shard alike
    monkeypatch.setattr(blocks, "moe_ffn", _moe_per_shard(2, 2, token_parallel))
    flat = tree_flatten_with_paths(params)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    tree = tree_unflatten({p: t for (p, _), t in zip(flat, leaves)})
    batch = {k: torch.as_tensor(v).long() for k, v in W.batch_at(cfg, 0).items()}
    loss, _ = steps.loss_fn(tree, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(got[0]["loss"], float(loss.detach()), rtol=1e-6)
    assert any(p.endswith("moe/router") for p, _ in flat)
    for (path, _), g in zip(flat, grads):
        np.testing.assert_allclose(got[0]["grads"][path], g.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=path)


# --------------------------------------------------------------------------
# 4: the scan under lru
# --------------------------------------------------------------------------

def test_recurrentgemma_scan_sharded_over_lru(ranks):
    got = _case(ranks, "recurrent")
    cfg = W.tiny("recurrentgemma-2b", "float32")
    with torch.no_grad():
        want, _ = lm.lm_apply(steps.init_params(cfg, 0),
                              torch.as_tensor(W.batch_at(cfg, 0, s=40)["tokens"]).long(), cfg,
                              mode="prefill")
    np.testing.assert_allclose(got[0]["logits"], want.numpy(), atol=1e-5, rtol=0)
    assert got[0]["scans"] and all(a == b == ("S(0)", "S(2)") for a, b in got[0]["scans"])


def test_recurrentgemma_sp_fp32_params_within_1e5(ranks):
    """--sp splits the residual's sequence over model; the scan's input is
    gathered on time (the reference's XLA gathers it) and trains."""
    got = _case(ranks, "rg_2x2_sp_fp32")
    _, want = _unsharded_train("recurrentgemma-2b", "float32")
    assert set(got[0]["params"]) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[0]["params"][path], w, atol=1e-5, rtol=0, err_msg=path)


# --------------------------------------------------------------------------
# 5: elastic restore 2x2 -> 4x1
# --------------------------------------------------------------------------

def test_elastic_restore_2x2_to_4x1(ranks):
    got = _case(ranks, "elastic")
    np.testing.assert_allclose(got[0]["loss_b"], got[0]["loss_a2"], rtol=2e-3)
    # ZeRO-1 on 4x1: m's embedding split 4 ways over data, on every rank
    assert all(r["restored_shapes"]["embed"] == (64, 64) for r in got)


def test_elastic_checkpoint_reads_in_the_reference(ranks):
    _, out = ranks
    cfg = jget_tiny("smollm-360m")
    state, _ = jckpt.restore(JDirBucket(os.path.join(out, "elastic")), "run", 2,
                             like=jsteps.abstract_train_state(cfg))
    want = jsteps.abstract_train_state(cfg)
    for a, w in zip(jax.tree.leaves(state), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
    assert int(state.step) == 2
    port, _ = ckpt.restore(DirBucket(os.path.join(out, "elastic")), "run", 2,
                           like=steps.abstract_train_state(W.tiny("smollm-360m", "bfloat16")))
    assert int(port.step) == 2


# --------------------------------------------------------------------------
# 6: the CLI's same-mesh resume
# --------------------------------------------------------------------------

def test_cli_2x2_resume_is_bit_equal(ranks):
    got = _case(ranks, "cli")
    assert all(r["crashed"] and r["step"] == 6 for r in got)
    _, out = ranks
    a, b = DirBucket(os.path.join(out, "cli_a")), DirBucket(os.path.join(out, "cli_b"))
    assert ckpt.steps_available(a, "ckpt") == ckpt.steps_available(b, "ckpt") == [3, 6]
    want, _ = ckpt.restore(a, "ckpt", 6)
    have, _ = ckpt.restore(b, "ckpt", 6)
    assert set(have) == set(want)
    for path in want:
        assert have[path].dtype == want[path].dtype and torch.equal(have[path], want[path]), path


# --------------------------------------------------------------------------
# 7: serving on 2x2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,arch,prompt_len,split", [
    ("serve_2x2", "qwen2.5-3b", 16, ("S(0)", "S(1)")),
    ("serve_2x2_ctx", "qwen2.5-3b", 16, ("S(0)", "S(1)")),  # kv heads take model first
    ("serve_rg_2x2_ctx", "recurrentgemma-2b", 18, ("S(0)", "S(2)")),  # kv_seq split
    ("serve_1x4_ctx", "qwen2.5-3b", 18, ("R", "S(2)"))])  # q heads split, kv_seq split
def test_serve_2x2_tokens_equal_unsharded(ranks, case, arch, prompt_len, split, monkeypatch):
    got = _case(ranks, case)
    monkeypatch.setattr(serve_mod, "get_tiny_config", lambda a: W.tiny(a, "float32"))
    engine = serve_mod.ServeEngine(arch, tiny=True, device="cpu")
    prompts = np.random.default_rng(0).integers(0, engine.cfg.vocab_size, (W.B, prompt_len))
    want = engine.generate(prompts, 6)["tokens"].numpy()
    for r in got:
        np.testing.assert_array_equal(r["tokens"], want)
        assert r["caches"] and all(c == split for c in r["caches"])


# --------------------------------------------------------------------------
# the kernels' dispatchers refuse what they cannot run on local shards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,error", [("flash seq split", "ValueError"),
                                        ("flash partial", "ValueError"),
                                        ("flash plain kv", "TypeError"),
                                        ("scan time split", "ValueError")])
def test_kernel_dispatch_raises_rather_than_gathers(ranks, name, error):
    for r in _case(ranks, "ops_refuse"):
        assert r[name] == error, (name, r[name])

