"""The ranks' side of ``tests/test_torch_distributed.py``: gloo processes on
the CPU, each running the port on a mesh and writing what it saw to
``<out>/rank<r>.pt``. Imports torch and the port only (no JAX), so that a
spawned rank starts fast; the test compares the results with the port's
unsharded runs and with the JAX package."""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

B, S = 4, 32
OPT = dict(total_steps=10, warmup_steps=0)


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def np32(t) -> np.ndarray:
    return whole(t).detach().float().numpy()


def local_shapes(tree) -> dict:
    from repro_torch.utils.trees import tree_flatten_with_paths
    return {p: tuple(t.to_local().shape) for p, t in tree_flatten_with_paths(tree)}


def full_leaves(tree) -> dict:
    """{path: fp32 numpy} of every leaf, gathered (a collective on every rank)."""
    from repro_torch.utils.trees import tree_flatten_with_paths
    return {p: np32(t) for p, t in tree_flatten_with_paths(tree)}


def env_of(shape, overrides=None):
    from repro_torch.launch.mesh import make_env, make_test_mesh
    return make_env(make_test_mesh(*shape), overrides)


def batch_at(cfg, step, b=B, s=S):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(cfg.vocab_size, s, b, seed=0)).batch_at(step)


def tiny(arch, dtype):
    from repro_torch.configs import get_tiny_config
    return get_tiny_config(arch).replace(dtype=dtype)


def spy(module, name, log):
    """Wrap ``module.name`` to log the DTensor placements it is called with."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        log.append(tuple(tuple(str(p) for p in t.placements)
                         for t in args if isinstance(t, DTensor)))
        return orig(*args, **kwargs)

    setattr(module, name, wrapped)
    return orig


# --------------------------------------------------------------------------
# the cases: each returns a dict of picklable results
# --------------------------------------------------------------------------

def train(arch, dtype, shape, n_steps=2, logits=False, overrides=None):
    """n_steps train steps on a ``shape`` mesh (its rules with
    ``overrides``) from the seed-0 state: the losses, every rank's local
    shapes of params and m/v/master, the final params; with ``logits`` also
    the fp32 prefill logits before training."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    from repro_torch.parallel import use_env
    from repro_torch.data.pipeline import shard_batch

    cfg = tiny(arch, dtype)
    env = env_of(shape, overrides)
    out, flash = {}, []
    orig = spy(ops, "heads_local", flash)
    try:
        with use_env(env):
            st = steps.place_tree(steps.init_train_state(cfg, 0),
                                  steps.train_state_shardings(cfg, env))
            out["shapes"] = {"params": local_shapes(st.params),
                             **{k: local_shapes(getattr(st.opt, k)) for k in ("m", "v", "master")}}
            if logits:
                with torch.no_grad():
                    lg, _ = lm.lm_apply(st.params, shard_batch(batch_at(cfg, 0), env)["tokens"],
                                        cfg, mode="prefill")
                out["logits"] = np32(lg)
            ts = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))
            out["losses"], out["gnorms"] = [], []
            for i in range(n_steps):
                st, m = ts(st, batch_at(cfg, i))
                out["losses"].append(float(m["loss"]))
                out["gnorms"].append(float(m["grad_norm"]))
        out["params"] = full_leaves(st.params)
    finally:
        ops.heads_local = orig
    out["flash"] = flash
    return out


def moe(arch, shape=(2, 2)):
    """The MoE layer of block 0 under the mesh on a seeded x, and the
    gradients of the whole tiny model's fp32 loss on one batch."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import steps
    from repro_torch.nn.moe import moe_branch, moe_ffn
    from repro_torch.parallel import use_env
    from repro_torch.parallel.sharding import NamedSharding, logical_to_spec, place
    from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

    cfg = tiny(arch, "float32")
    env = env_of(shape)
    params = steps.init_params(cfg, 0)
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out = {"branch": moe_branch(cfg.n_experts, S, env.axis_size("model"))}
    with use_env(env):
        pp = steps.place_tree(params, steps.param_shardings(steps.param_axes(cfg), params, env))
        xd = place(x, NamedSharding(env.mesh, logical_to_spec(("batch", "seq", "embed"),
                                                              env, x.shape)))
        with torch.no_grad():
            y, aux = moe_ffn(pp["blocks"]["layers"][0]["moe"], xd, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor, act=cfg.act)
        out["y"], out["aux"] = np32(y), float(whole(aux))
        flat = tree_flatten_with_paths(pp)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        tree = tree_unflatten({p: t for (p, _), t in zip(flat, leaves)})
        loss, _ = steps.loss_fn(tree, shard_batch(batch_at(cfg, 0), env), cfg)
        grads = torch.autograd.grad(loss, leaves)
        out["loss"] = float(whole(loss.detach()))
        out["grads"] = {p: np32(g) for (p, _), g in zip(flat, grads)}
    return out


def recurrent_prefill(shape=(2, 2)):
    """recurrentgemma-tiny's fp32 prefill logits, the scan sharded over lru."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.models import lm, steps
    from repro_torch.parallel import use_env

    cfg = tiny("recurrentgemma-2b", "float32")
    env = env_of(shape)
    scans = []
    orig = spy(ops, "_scan_local", scans)
    try:
        params = steps.init_params(cfg, 0)
        with use_env(env), torch.no_grad():
            pp = steps.place_tree(params, steps.param_shardings(steps.param_axes(cfg),
                                                                params, env))
            tokens = shard_batch(batch_at(cfg, 0, s=40), env)["tokens"]
            lg, _ = lm.lm_apply(pp, tokens, cfg, mode="prefill")
    finally:
        ops._scan_local = orig
    return {"logits": np32(lg), "scans": scans}


def elastic(out_dir):
    """smollm-tiny: 2 steps on 2x2, a checkpoint, then one step restored onto
    4x1 beside one step more on 2x2 (the reference's elastic test)."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.objectstore import DirBucket
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    from repro_torch.parallel import use_env

    cfg = tiny("smollm-360m", "bfloat16")
    batch = batch_at(cfg, 0)
    bucket = DirBucket(os.path.join(out_dir, "elastic"))
    env_a, env_b = env_of((2, 2)), env_of((4, 1))
    out = {}
    with use_env(env_a):
        ts = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))
        st = steps.place_tree(steps.init_train_state(cfg, 0),
                              steps.train_state_shardings(cfg, env_a))
        st, _ = ts(st, batch)
        st, _ = ts(st, batch)
        ckpt.save(bucket, "run", 2, st)
    with use_env(env_b):
        sh_b = steps.train_state_shardings(cfg, env_b)
        st_b, _ = ckpt.restore(bucket, "run", 2, like=steps.abstract_train_state(cfg),
                               shardings=sh_b)
        out["restored_shapes"] = local_shapes(st_b.opt.m)
        st_b, m_b = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))(st_b, batch)
        out["loss_b"] = float(m_b["loss"])
    with use_env(env_a):
        _, m_a2 = ts(st, batch)
        out["loss_a2"] = float(m_a2["loss"])
    return out


class _Crash(Exception):
    pass


def cli(out_dir):
    """The train CLI on 2x2: 6 steps, and a run that crashes in step 5
    (after its step-3 checkpoint) started again with the same arguments."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import train as train_cli
    from repro_torch.models import steps

    base = ["--arch", "smollm-360m", "--tiny", "--device", "cpu", "--mesh", "2x2",
            "--batch", "4", "--seq", "16", "--steps", "6", "--ckpt-every", "3",
            "--log-every", "3", "--warmup", "2"]
    train_cli.main(base + ["--ckpt-dir", os.path.join(out_dir, "cli_a")])
    checkpointers, make_step = [], steps.make_train_step
    init = ckpt.AsyncCheckpointer.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        checkpointers.append(self)

    def crashing_make_step(*args, **kwargs):
        step, calls = make_step(*args, **kwargs), []

        def crashing(state, batch):
            calls.append(1)
            if len(calls) == 5:
                for c in checkpointers:
                    c.wait()  # the step-3 checkpoint is on disk, as a crash finds it
                raise _Crash
            return step(state, batch)

        return crashing

    ckpt.AsyncCheckpointer.__init__ = recording_init
    steps.make_train_step = crashing_make_step
    crashed = False
    try:
        train_cli.main(base + ["--ckpt-dir", os.path.join(out_dir, "cli_b")])
    except _Crash:
        crashed = True
    finally:
        ckpt.AsyncCheckpointer.__init__ = init
        steps.make_train_step = make_step
    state = train_cli.main(base + ["--ckpt-dir", os.path.join(out_dir, "cli_b")])
    return {"crashed": crashed, "step": int(whole(state.step))}


def serve(arch, shape, ctx_parallel, prompt_len=16):
    """6 greedy fp32 tokens of ``ServeEngine`` on the mesh, and the decode
    cache's placements."""
    from repro_torch.launch import serve as serve_mod

    serve_mod.get_tiny_config = lambda a: tiny(a, "float32")  # this rank's engines in fp32
    engine = serve_mod.ServeEngine(arch, tiny=True, device="cpu",
                                   mesh="x".join(map(str, shape)),
                                   ctx_parallel=ctx_parallel)
    prompts = np.random.default_rng(0).integers(0, engine.cfg.vocab_size, (B, prompt_len))
    caches = []
    orig = serve_mod._install_prefill

    def logged(states, pf_states):
        new = orig(states, pf_states)
        leaves = new if isinstance(new, list) else [new]
        caches.extend(tuple(str(p) for p in c.k.placements) for c in leaves
                      if isinstance(c, serve_mod.KVCache))
        return new

    serve_mod._install_prefill = logged
    try:
        tokens = engine.generate(prompts, 6)["tokens"].numpy()
    finally:
        serve_mod._install_prefill = orig
    return {"tokens": tokens, "caches": caches}


def ops_refuse(shape=(2, 2)):
    """The kernels' dispatchers given DTensors split where the kernels
    cannot run on local shards (flash on its sequence, the scan on its
    time axis), or partial, or beside a plain tensor: each must raise, with
    no gather. Returns {case: the exception's type name, or None}."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels import ops

    env = env_of(shape)
    mesh = env.mesh
    g = torch.Generator().manual_seed(3)

    def dt(shape_, placements):
        t = torch.randn(shape_, generator=g)
        return DTensor.from_local(t, mesh, placements, run_check=False)

    q = dt((2, 4, 8, 16), (Replicate(), Shard(2)))  # split on the sequence
    k = dt((2, 2, 8, 16), (Replicate(), Shard(2)))
    a = dt((2, 8, 4), (Replicate(), Shard(1)))  # split on time
    part = dt((2, 4, 8, 16), (Replicate(), Partial()))
    whole = dt((2, 4, 8, 16), (Replicate(), Replicate()))
    cases = {"flash seq split": lambda: ops.flash_attention(q, k, k),
             "flash partial": lambda: ops.flash_attention(part, part, part),
             "flash plain kv": lambda: ops.flash_attention(whole, torch.ones(2, 4, 8, 16),
                                                           torch.ones(2, 4, 8, 16)),
             "scan time split": lambda: ops.rglru_scan(a, a)}
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, TypeError) as e:
            out[name] = type(e).__name__
    return out


CASES = {
    "qwen_2x2_bf16": lambda out: train("qwen2.5-3b", "bfloat16", (2, 2)),
    "qwen_2x2_fp32": lambda out: train("qwen2.5-3b", "float32", (2, 2)),
    "qwen_1x4_fp32": lambda out: train("qwen2.5-3b", "float32", (1, 4), logits=True),
    "qwen_2x2_sp_fp32": lambda out: train("qwen2.5-3b", "float32", (2, 2),
                                          overrides={"seq": "model"}),
    "qwen_2x2_batch_tp_fp32": lambda out: train("qwen2.5-3b", "float32", (2, 2),
                                                overrides={"batch_attn": ("data", "model")}),
    "rg_2x2_sp_fp32": lambda out: train("recurrentgemma-2b", "float32", (2, 2),
                                        overrides={"seq": "model"}),
    "moe_qwen3": lambda out: moe("qwen3-moe-235b-a22b"),
    "moe_granite": lambda out: moe("granite-moe-3b-a800m"),
    "recurrent": lambda out: recurrent_prefill(),
    "elastic": elastic,
    "cli": cli,
    "serve_2x2": lambda out: serve("qwen2.5-3b", (2, 2), False),
    "serve_2x2_ctx": lambda out: serve("qwen2.5-3b", (2, 2), True),
    "serve_rg_2x2_ctx": lambda out: serve("recurrentgemma-2b", (2, 2), True, prompt_len=18),
    "serve_1x4_ctx": lambda out: serve("qwen2.5-3b", (1, 4), True, prompt_len=18),
    "ops_refuse": lambda out: ops_refuse(),
}


def run(rank, world, init_file, out_dir, names):
    """One rank: join the gloo group, run the named cases, save the results
    (an exception's traceback in place of a case's results)."""
    torch.set_num_threads(1)  # the ranks share the machine's cores
    from repro_torch.launch.mesh import init_process_group
    init_process_group("cpu", init_method=f"file://{init_file}", rank=rank,
                       world_size=world)
    results = {}
    for name in names:
        try:
            results[name] = CASES[name](out_dir)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
            break  # the group's collectives are out of step now
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    sys.stdout.flush()
