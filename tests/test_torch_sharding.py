"""The port's sharding policy (repro_torch.parallel) against the JAX
package's (repro.parallel), with no processes: spec derivation reads only a
mesh's axis names and sizes, so both sides run on abstract meshes of any
size (jax's ``AbstractMesh(sizes, names)``, the port's ``AbstractMesh``).

For every arch, full and tiny, on 2x2, 1x4, 4x1, 16x16 and 2x16x16 meshes,
with no override, ``--sp``, ``--batch-tp`` and ctx-parallel's ``kv_seq``,
the port's param and ZeRO-1 optimizer specs equal the reference's leaf for
leaf, and so do the specs of the activations at the model's ``shard`` points
and of the decode state. Then ``zero1_spec``'s cases and
``spec_to_placements``."""

import functools

import numpy as np

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config, get_tiny_config as jget_tiny
from repro.launch.mesh import make_env as jmake_env
from repro.models import steps as jsteps
from repro.nn.blocks import init_stack_state as jinit_stack_state
from repro.nn.blocks import stack_state_axes as jstack_state_axes
from repro.parallel import logical_to_spec as jlogical_to_spec
from repro.parallel import param_shardings as jparam_shardings
from repro.parallel.zero import opt_state_shardings as jopt_state_shardings
from repro.parallel.zero import zero1_spec as jzero1_spec

from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.launch.mesh import make_env
from repro_torch.models import steps
from repro_torch.nn.blocks import stack_state_axes
from repro_torch.parallel import logical_to_spec, param_shardings
from repro_torch.parallel.sharding import (
    AbstractMesh,
    NamedSharding,
    P,
    shard_shape,
    spec_to_placements,
)
from repro_torch.parallel.zero import opt_state_shardings, zero1_spec
from repro_torch.utils.trees import tree_flatten_with_paths

MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OVERRIDES = {"none": {}, "sp": {"seq": "model"},
             "batch_tp": {"batch_attn": ("data", "model")}, "kv_seq": {"kv_seq": "model"}}
B, S = 64, 512  # a batch and sequence every mesh's DP and model axes divide


def _envs(mesh, override):
    sizes, names = MESHES[mesh]
    return (jmake_env(jax.sharding.AbstractMesh(sizes, names), OVERRIDES[override]),
            make_env(AbstractMesh(sizes, names), OVERRIDES[override]))


@functools.cache
def _models(arch, size):
    """(reference config, port config, reference abstract params and axes,
    port abstract params and axes)."""
    jcfg = (jget_tiny if size == "tiny" else jget_config)(arch)
    cfg = (get_tiny_config if size == "tiny" else get_config)(arch)
    return (jcfg, cfg, jsteps.abstract_params(jcfg), jsteps.param_axes(jcfg),
            steps.abstract_params(cfg), steps.param_axes(cfg))


def _specs(tree):
    """{path: spec entries} of a port tree of NamedShardings."""
    return {p: tuple(s.spec) for p, s in tree_flatten_with_paths(tree)}


def _jpath(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def _jflat(tree) -> dict:
    """{path: leaf} of a reference tree, NamedShardings as leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {_jpath(path): leaf for path, leaf in flat}


def _jspecs(tree):
    return {p: tuple(s.spec) for p, s in _jflat(tree).items()}


def _is_axes(leaf) -> bool:
    return isinstance(leaf, tuple) and all(isinstance(a, (str, type(None))) for a in leaf)


def _activation_points(cfg):
    """(logical axes, shape) at the model's shard points, at batch B and
    sequence S."""
    w = cfg.lru_width or cfg.d_model
    return [(("batch", "seq", "embed"), (B, S, cfg.d_model)),
            (("batch", "enc_seq", "embed"), (B, S, cfg.d_model)),
            (("batch_attn", "heads", "attn_seq", "head_dim"), (B, cfg.n_heads, S, cfg.hd)),
            (("batch_attn", "kv_heads", "attn_seq", "head_dim"),
             (B, cfg.n_kv_heads, S, cfg.hd)),
            (("batch", "seq", "mlp"), (B, S, cfg.d_ff)),
            (("batch", "seq", "lru"), (B, S, w)),
            (("batch", "seq", "vocab"), (B, S, cfg.vocab_size)),
            (("batch", None), (B, S))]


@pytest.mark.parametrize("override", list(OVERRIDES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, size, mesh, override):
    jenv, env = _envs(mesh, override)
    jcfg, cfg, jap, jax_axes, ap, axes = _models(arch, size)
    want = _jspecs(jparam_shardings(jax_axes, jap, jenv))
    got = _specs(param_shardings(axes, ap, env))
    assert got == want
    jopt, opt = jopt_state_shardings(jax_axes, jap, jenv), opt_state_shardings(axes, ap, env)
    for part in ("m", "v", "master"):
        assert _specs(getattr(opt, part)) == _jspecs(getattr(jopt, part)), part
    for names, shape in _activation_points(cfg):
        assert tuple(logical_to_spec(names, env, shape)) == \
            tuple(jlogical_to_spec(names, jenv, shape)), names
    if not cfg.is_encoder_decoder:
        jstate = jax.eval_shape(lambda: jinit_stack_state(jcfg, B, S))
        want = jax.tree.map(lambda ax, a: repr(tuple(jlogical_to_spec(ax, jenv, a.shape))),
                            jstack_state_axes(jcfg), jstate, is_leaf=_is_axes)
        want = {_jpath(p): s for p, s in jax.tree_util.tree_flatten_with_path(want)[0]}
        got = _specs(param_shardings(stack_state_axes(cfg), jstate, env))
        assert {p: repr(s) for p, s in got.items()} == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", ["full", "tiny"])
def test_shard_shapes_equal_reference(size, mesh):
    """Each device's local shape of every param and optimizer leaf of a
    dense and an MoE arch, under either package's shardings."""
    jenv, env = _envs(mesh, "none")
    for arch in ("qwen2.5-3b", "qwen3-moe-235b-a22b"):
        _, _, jap, jax_axes, ap, axes = _models(arch, size)
        shapes = {p: a.shape for p, a in _jflat(jap).items()}
        for got, want in ((param_shardings(axes, ap, env), jparam_shardings(jax_axes, jap, jenv)),
                          (opt_state_shardings(axes, ap, env).m,
                           jopt_state_shardings(jax_axes, jap, jenv).m)):
            want = _jflat(want)
            for path, sh in tree_flatten_with_paths(got):
                assert sh.shard_shape(shapes[path]) == want[path].shard_shape(shapes[path]), path


# --------------------------------------------------------------------------
# zero1_spec (the reference's tests/test_sharding.py cases) and placements
# --------------------------------------------------------------------------

ZERO_CASES = [  # (param spec entries, shape)
    ((None, "model"), (64, 64)),   # model on dim 1: data joins dim 0
    ((), (3, 64)),                 # dim 0 indivisible: data goes to dim 1
    (("model",), (64, 8)),         # data after model on dim 0: ("model", "data")
    (("model",), (2, 3)),          # nothing divides: unchanged
    (("data",), (64, 64)),         # already DP-sharded: unchanged
    ((), ()),                      # a scalar
]


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "16x16", "2x16x16"])
@pytest.mark.parametrize("case", range(len(ZERO_CASES)))
def test_zero1_spec_equals_reference(mesh, case):
    from jax.sharding import PartitionSpec as JP
    jenv, env = _envs(mesh, "none")
    entries, shape = ZERO_CASES[case]
    if "pod" in env.shape and entries == ("data",):
        entries = (("pod", "data"),)
    assert tuple(zero1_spec(P(*entries), shape, env)) == \
        tuple(jzero1_spec(JP(*entries), shape, jenv))


def test_zero1_insertion():
    """The reference's ``test_zero1_insertion`` on the port."""
    env = make_env(AbstractMesh((2, 2), ("data", "model")))
    assert zero1_spec(P(None, "model"), (64, 64), env) == P("data", "model")
    assert zero1_spec(P(), (3, 64), env) in (P(None, "data"), P())


def test_logical_rules_basic():
    """The reference's ``test_logical_rules_basic``, dropped axes and the
    one-use rule on the port."""
    env = make_env(AbstractMesh((2, 2), ("data", "model")))
    assert logical_to_spec(("batch", None, "embed"), env, (8, 16, 32)) == P("data")
    assert logical_to_spec(("embed", "mlp"), env, (32, 64)) == P(None, "model")
    assert logical_to_spec(("vocab", "embed"), env, (100, 32)) == P("model")
    assert logical_to_spec(("embed", "heads", "head_dim"), env, (32, 15, 64)) == P()
    assert logical_to_spec(("vocab", "mlp"), env, (64, 64)) == P("model")


PLACEMENT_CASES = [  # (spec entries, mesh, placements in mesh order)
    ((), "2x2", (Replicate(), Replicate())),
    (("data",), "2x2", (Shard(0), Replicate())),
    ((None, "model"), "2x2", (Replicate(), Shard(1))),
    (("data", "model"), "2x2", (Shard(0), Shard(1))),
    ((("data", "model"),), "2x2", (Shard(0), Shard(0))),
    ((("model", "data"),), "2x2", (Shard(0), Shard(0))),  # DTensor's order (C.17)
    ((None, "model"), "4x1", (Replicate(), Replicate())),  # a size-1 axis
    ((("pod", "data"), None, "model"), "2x16x16", (Shard(0), Shard(0), Shard(2))),
]


@pytest.mark.parametrize("case", range(len(PLACEMENT_CASES)))
def test_spec_to_placements(case):
    entries, mesh, want = PLACEMENT_CASES[case]
    sizes, names = MESHES[mesh]
    assert spec_to_placements(P(*entries), AbstractMesh(sizes, names)) == want


def test_shard_shape_and_named_sharding():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    sh = NamedSharding(mesh, P(("data", "model"), None, "model"))
    assert sh.shard_shape((16, 3, 8)) == (2, 3, 2) == shard_shape(sh.spec, (16, 3, 8), mesh)
    assert sh.placements == (Shard(0), Shard(2))


def test_shard_without_env_is_identity_and_plain_tensor_under_env_raises():
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.parallel import shard, use_env
    x = torch.ones(2, 3)
    assert shard(x, "batch", "embed") is x
    owned = not dist.is_initialized()
    init_process_group("cpu")
    try:
        env = make_env(make_mesh((1, 1), ("data", "model"), "cpu"))
        with use_env(env), pytest.raises(TypeError, match="plain tensor"):
            shard(x, "batch", "embed")
    finally:
        if owned:
            dist.destroy_process_group()


def test_remat_recompute_in_another_thread_keeps_the_mesh_env():
    """The backward's recompute of a remat layer runs in whatever thread
    runs the backward (on the card, autograd's device thread, whose env
    stack is empty): it must still see the forward's mesh env, or the MoE
    would take its no-mesh path on DTensors. Gradients of a granite-tiny
    loss on a 1x1 mesh, taken in another thread, equal the unsharded ones."""
    import threading

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.parallel import use_env
    from repro_torch.utils.trees import tree_unflatten

    cfg = get_tiny_config("granite-moe-3b-a800m").replace(dtype="float32", remat="full")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}

    def grads(params, env=None):
        flat = tree_flatten_with_paths(params)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        tree = tree_unflatten({p: t for (p, _), t in zip(flat, leaves)})
        if env is None:
            loss, _ = steps.loss_fn(tree, shard_batch(batch), cfg)
            return torch.autograd.grad(loss, leaves)
        with use_env(env):
            loss, _ = steps.loss_fn(tree, shard_batch(batch, env), cfg)
        out = {}

        def backward():  # no env in this thread
            try:
                out["grads"] = torch.autograd.grad(loss, leaves)
            except Exception as e:  # noqa: BLE001 - reported below
                out["error"] = e

        t = threading.Thread(target=backward, daemon=True)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and "error" not in out, out.get("error")
        return [g.full_tensor() for g in out["grads"]]

    params = steps.init_params(cfg, 0)
    want = grads(params)
    owned = not dist.is_initialized()
    init_process_group("cpu")
    try:
        env = make_env(make_mesh((1, 1), ("data", "model"), "cpu"))
        placed = steps.place_tree(params, param_shardings(steps.param_axes(cfg), params, env))
        got = grads(placed, env)
    finally:
        if owned:
            dist.destroy_process_group()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=1e-6)
