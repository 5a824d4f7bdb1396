"""The port's dry-run (``repro_torch.launch.dryrun``) and its helpers against
the JAX package's.

With no process group, in this process: ``SHAPES``, ``cells`` and
``all_cells``; ``input_specs`` for every cell, the stack's decode state
(compact and not), whisper's ``abstract_decode_state`` and
``decode_state_axes``, ``adamw.abstract_state``, ``tree_count`` and
``tree_bytes``, leaf for leaf (paths, shapes, dtypes) at full width with no
allocation; and one small train cell's FLOPs and argument bytes against the
reference's ``hlo_cost.analyze`` and ``memory_analysis`` of the same cell.

On fake process groups, in worker processes of their own
(``tests/_torch_dryrun_worker.py``): every arch's train_4k inputs placed on
16x16 and 2x16x16 hold, on a rank, the bytes of the reference's
``NamedSharding.shard_shape``\\ s; every arch's tiny config runs train,
prefill and decode on 2x2 and 2x2x2; at full width, recurrentgemma-2b's and
xlstm-125m's train_4k on 16x16 (their head reshapes on a 16-way split),
llama3-8b's prefill_32k on 2x16x16 (the greedy argmax) and whisper-tiny's
train_4k and decode_32k on 16x16; the CLI writes the reference's keys.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dryrun_worker as W

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_cells as jall_cells
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.launch import hlo_cost
from repro.launch.mesh import make_env as jmake_env
from repro.models import encdec as jencdec
from repro.models import steps as jsteps
from repro.nn.blocks import init_stack_state as jinit_stack_state
from repro.optim import adamw as jadamw
from repro.parallel import logical_to_spec as jlogical_to_spec
from repro.parallel import param_shardings as jparam_shardings
from repro.parallel.zero import opt_state_shardings as jopt_state_shardings
from repro.utils.trees import tree_bytes as jtree_bytes
from repro.utils.trees import tree_count as jtree_count

from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, cells, get_config, get_tiny_config
from repro_torch.kernels import cost
from repro_torch.launch import op_cost
from repro_torch.models import encdec, steps
from repro_torch.nn.blocks import init_stack_state
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import place_abstract
from repro_torch.utils.trees import tree_bytes, tree_count, tree_flatten_with_paths

FULL = [("recurrentgemma-2b", "train_4k", "sp"), ("xlstm-125m", "train_4k", "sp"),
        ("llama3-8b", "prefill_32k", "mp"), ("whisper-tiny", "train_4k", "sp"),
        ("whisper-tiny", "decode_32k", "sp")]
TINY_MESHES = ("2x2", "2x2x2")
KINDS = ("train", "prefill", "decode")


def _jpath(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def _jleaves(tree) -> dict:
    """{path: (shape, dtype name)} of a reference tree of arrays or
    ShapeDtypeStructs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_jpath(p): (tuple(a.shape), str(jnp.dtype(a.dtype))) for p, a in flat}


def _leaves(tree) -> dict:
    return {p: (tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for p, a in tree_flatten_with_paths(tree)}


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        assert cells(arch) == jcells(arch)
    assert all_cells() == jall_cells()
    assert len(all_cells()) == 32


@pytest.mark.parametrize("arch,shape", jall_cells())
def test_input_specs_equal_reference(arch, shape):
    """Leaf for leaf: a decode cell's is the whole (compact) decode state."""
    got = _leaves(steps.input_specs(get_config(arch), SHAPES[shape]))
    want = _jleaves(jsteps.input_specs(jget_config(arch), JSHAPES[shape]))
    assert got == want


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "whisper-tiny"])
def test_stack_state_equals_reference(arch, compact):
    cfg, jcfg = get_config(arch), jget_config(arch)
    b, s = 2, 524288  # long_500k's length: a local window's cache is cut by compact
    got = _leaves(init_stack_state(cfg, b, s, torch.bfloat16, "meta", compact=compact))
    want = _jleaves(jax.eval_shape(lambda: jinit_stack_state(jcfg, b, s, jnp.bfloat16,
                                                             compact=compact)))
    assert got == want
    if compact and cfg.local_window:
        assert any(shape[-2] == cfg.local_window + 1 for shape, _ in got.values())


def test_encdec_decode_state_and_axes_equal_reference():
    cfg, jcfg = get_config("whisper-tiny"), jget_config("whisper-tiny")
    got = _leaves(encdec.abstract_decode_state(cfg, 4, 64, torch.bfloat16))
    assert got == _jleaves(jencdec.abstract_decode_state(jcfg, 4, 64, jnp.bfloat16))

    def plain(axes):  # KVCache fields and the (k, v) pair as tuples of axes tuples
        return [{"self": tuple(layer["self"]), "cross_kv": tuple(layer["cross_kv"])}
                for layer in axes]

    assert plain(encdec.decode_state_axes(cfg)) == plain(jencdec.decode_state_axes(jcfg))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_and_tree_bytes_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    state, jstate = steps.abstract_train_state(cfg), jsteps.abstract_train_state(jcfg)
    assert _leaves(state) == _jleaves(jstate)
    assert _leaves(adamw.abstract_state(state.params)) == \
        _jleaves(jadamw.abstract_state(jstate.params))
    assert tree_bytes(state) == jtree_bytes(jstate)
    assert tree_count(state) == jtree_count(jstate)
    placed = place_abstract(state, None)  # meta tensors: the same counts, no storage
    assert tree_bytes(placed) == jtree_bytes(jstate) and tree_count(placed) == jtree_count(jstate)


# --------------------------------------------------------------------------
# one small train cell against the reference's compiled HLO
# --------------------------------------------------------------------------

def _reference_cell(cfg, b, s):
    astate = jsteps.abstract_train_state(cfg)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32) for k in ("tokens", "labels")}
    step = jsteps.make_train_step(cfg, jadamw.AdamWConfig(total_steps=10))
    return jax.jit(step).lower(astate, batch).compile()


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_flops_and_arg_bytes_match_reference(remat):
    """smollm-tiny, B2 x S64 (one 64-token chunk), no mesh. The reference's
    HLO counts the chunked twin's dots: every (query, key) pair of the one
    diagonal chunk, masked or not, where the kernels count the kept pairs
    only; that surplus is taken from the reference's count. What is left
    differs by the flash backward's recomputed S (2·D a kept pair and head,
    which XLA keeps from the forward) and agrees within 2%."""
    b, s = 2, 64
    jcfg = jget_tiny("smollm-360m").replace(remat=remat, attn_chunk=64)
    cfg = get_tiny_config("smollm-360m").replace(remat=remat, attn_chunk=64)
    compiled = _reference_cell(jcfg, b, s)
    ref = hlo_cost.analyze(compiled.as_text())["flops"]
    state = place_abstract(steps.abstract_train_state(cfg), None)
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta") for k in ("tokens", "labels")}
    got = op_cost.analyze(steps.make_train_step(cfg, adamw.AdamWConfig(total_steps=10)),
                          state, batch)
    kept = cost.unmasked_pairs(s, s, True, 0)
    passes = 2 if remat == "full" else 1  # the forward, and its recompute under remat
    per_pair = b * cfg.n_heads * cfg.hd * cfg.n_layers
    surplus = (s * s - kept) * per_pair * (4 * passes + 8)
    assert got["kernels"]["flash_attention"]["flops"] == 4 * kept * per_pair * passes
    assert abs(got["flops"] - (ref - surplus)) / (ref - surplus) < 0.02, (got["flops"], ref)
    assert got["flops"] == ref - surplus + 2 * kept * per_pair  # exactly the recomputed S
    assert got["arg_bytes"] == compiled.memory_analysis().argument_size_in_bytes


# --------------------------------------------------------------------------
# on fake process groups
# --------------------------------------------------------------------------

def _cases():
    return ([f"arg_bytes:{a}:{m}" for a in ARCH_IDS for m in ("sp", "mp")]
            + [f"full:{a}:{s}:{m}" for a, s, m in FULL]
            + [f"tiny:{a}:{k}:{m}" for m in TINY_MESHES for a in ARCH_IDS for k in KINDS]
            + ["cli"])


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    """Every case's result, from three worker processes at once."""
    return W.spawn(_cases(), str(tmp_path_factory.mktemp("dryrun")), jobs=3, timeout=600)


def _ok(results, case):
    assert case in results, f"{case}: its worker did not finish it"
    res = results[case]
    assert not (isinstance(res, dict) and "error" in res), res["error"]
    return res


def _ref_arg_bytes(arch, multi_pod):
    """The reference's per-device bytes of train_4k's inputs: the sum of the
    ``NamedSharding.shard_shape`` of every leaf, as its dry-run shards them."""
    sizes, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    mesh = jax.sharding.AbstractMesh(sizes, names)
    env = jmake_env(mesh)
    cfg = jget_config(arch)
    ap, axes = jsteps.abstract_params(cfg), jsteps.param_axes(cfg)
    shapes = {_jpath(p): a for p, a in jax.tree_util.tree_flatten_with_path(ap)[0]}
    total = 4  # the step, an int32, replicated
    is_sh = lambda x: isinstance(x, jax.sharding.NamedSharding)  # noqa: E731
    opt = jopt_state_shardings(axes, ap, env)
    for tree, f32 in ((jparam_shardings(axes, ap, env), False), (opt.m, True),
                      (opt.v, True), (opt.master, True)):
        for p, sh in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_sh)[0]:
            a = shapes[_jpath(p)]
            size = 4 if f32 else jnp.dtype(a.dtype).itemsize
            total += math.prod(sh.shard_shape(a.shape)) * size
    for name, a in jsteps.input_specs(cfg, JSHAPES["train_4k"])["batch"].items():
        axes = ("batch",) + (None,) * (len(a.shape) - 1)  # tokens, labels, frames
        sh = jax.sharding.NamedSharding(mesh, jlogical_to_spec(axes, env, a.shape))
        total += math.prod(sh.shard_shape(a.shape)) * jnp.dtype(a.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", ["sp", "mp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_rank_arg_bytes_equal_reference(fake, arch, mesh):
    got = _ok(fake, f"arg_bytes:{arch}:{mesh}")
    want = _ref_arg_bytes(arch, mesh == "mp")
    assert got == want
    if (arch, mesh) == ("recurrentgemma-2b", "sp"):
        assert got == 759_767_972  # the reference's dry-run, memory_analysis' argument size


@pytest.mark.parametrize("mesh", TINY_MESHES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tiny_cells_run_on_fake_meshes(fake, arch, kind, mesh):
    res = _ok(fake, f"tiny:{arch}:{kind}:{mesh}")
    assert res["mesh"] == mesh and res["kind"] == kind and res["finite"]
    assert res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert res["peak_bytes"] >= res["arg_bytes"] > 0
    if kind == "train":  # gradients are reduced over the data axis
        assert res["collective_bytes_per_device"] > 0


def _calls(res, name):
    return {**res["kernels"], **res["loops"]}.get(name, {}).get("calls", 0)


@pytest.mark.parametrize("arch,shape,mesh", FULL)
def test_full_width_cells(fake, arch, shape, mesh):
    """Cells that raised before their repairs: recurrentgemma's 10 heads and
    xlstm's 4 on a 16-way ``lru`` split (``heads_whole``), the greedy argmax
    of a 2x16x16 prefill (``steps.greedy``), whisper's cross-attention on
    local shards."""
    res = _ok(fake, f"full:{arch}:{shape}:{mesh}")
    assert res["finite"] and res["flops_per_device"] > 0 and res["peak_bytes"] > res["arg_bytes"]
    assert res["mesh"] == ("2x16x16" if mesh == "mp" else "16x16")
    cfg = get_config(arch)
    kinds = cfg.pattern_for_layers()
    passes = 2 if (SHAPES[shape].kind == "train" and not cfg.is_encoder_decoder) else 1
    if arch == "recurrentgemma-2b":
        assert _calls(res, "rglru_scan") == passes * kinds.count("rglru")
        assert _calls(res, "rglru_scan_bwd") == kinds.count("rglru")
        assert _calls(res, "flash_attention") == passes * kinds.count("attn")
    if arch == "xlstm-125m":
        assert _calls(res, "slstm_scan") == passes * kinds.count("slstm")
        assert _calls(res, "slstm_scan_bwd") == kinds.count("slstm")
    if arch == "llama3-8b":
        assert _calls(res, "flash_attention") == cfg.n_layers
        assert res["collective_bytes_per_device"] > 0
    if arch == "whisper-tiny":
        n = cfg.n_layers + cfg.n_enc_layers
        assert _calls(res, "flash_attention") == (n if shape == "train_4k" else 0)


def test_cli_writes_the_reference_keys(fake):
    res = _ok(fake, "cli")
    assert res["files"] == ["whisper-tiny__decode_32k__sp.json"]
    keys = {"arch", "shape", "mesh", "n_chips", "kind", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "collectives",
            "collective_counts", "param_bytes_global", "n_params", "n_active_params",
            "model_flops_global", "useful_flops_ratio", "compute_s", "memory_s",
            "collective_s", "bottleneck", "arg_bytes", "temp_bytes", "output_bytes"}
    out = res["result"]
    assert keys <= set(out) and {"trace_s", "peak_bytes", "fits_80gb"} <= set(out)
    assert not {"compile_s", "xla_flops_raw", "xla_bytes_raw"} & set(out)
    assert out["n_chips"] == 256 and out["fits_80gb"] is True
    assert np.isclose(out["useful_flops_ratio"],
                      out["model_flops_global"] / (out["flops_per_device"] * 256))
