"""Logical-axis sharding on a ``DeviceMesh``: the one place where the port's
parallelism policy lives (the reference's ``repro/parallel/sharding.py``).

Every parameter and activation is annotated with *logical* axis names
("batch", "embed", "heads", "mlp", "experts", ...). A :class:`MeshEnv` maps
them onto the mesh's physical axes through a rules table, so model code
never names a physical axis and the same model runs unsharded (no env), on
a (data, model) mesh or on a (pod, data, model) one, by swapping rules.

The reference's ``NamedSharding``\\ s become ``DTensor`` placements: a
:class:`PartitionSpec` (one entry per tensor dim, as the reference's) turns
into one ``Shard(d)`` or ``Replicate()`` per mesh dim (``spec_to_placements``),
and ``shard`` is a ``redistribute``. The port runs one process per device,
PyTorch's convention. Spec derivation reads only the mesh's axis names and
sizes, so it runs for a 16x16 or 2x16x16 mesh with no processes at all
(:class:`AbstractMesh`).

Under an active env the model's activations are DTensors: ``shard`` raises
on a plain tensor, so a local computation never stands in silently for a
sharded one. ``use_env`` lets plain constants (positions, masks, rotary
tables) take part as replicated values (``implicit_replication``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.utils.trees import tree_flatten_with_paths, tree_map_with_path

# A logical rule maps a logical axis name to one mesh axis, a tuple of mesh
# axes (sharded over their product), or None (replicated).
MeshAxes = Union[None, str, tuple]

# Baseline rules for a (data, model) single-pod mesh.
SINGLE_POD_RULES: dict[str, MeshAxes] = {
    "batch": ("data",),
    "batch_attn": ("data",),  # attention-block batch (the batch-TP override
                              # reshards attention over data x model when
                              # heads % TP != 0 would replicate compute)
    "seq": None,            # residual-stream sequence axis (SP shards this)
    "attn_seq": None,       # attention-internal q seq (never SP-sharded)
    "kv_seq": None,         # kv-cache sequence axis
    "embed": None,
    "residual": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "lru": "model",
    "conv": None,
    "layers": None,
    "enc_seq": None,
    "zero": None,           # extra axis ZeRO-1 adds to optimizer state
}

# Production multi-pod rules: the pod axis joins the data axis for DP.
MULTI_POD_RULES: dict[str, MeshAxes] = dict(
    SINGLE_POD_RULES,
    batch=("pod", "data"),
    batch_attn=("pod", "data"),
)


def zero1_rules(rules: dict[str, MeshAxes]) -> dict[str, MeshAxes]:
    """Rules with the ZeRO-1 axis bound to the DP axes (optimizer sharding)."""
    return dict(rules, zero=rules["batch"])


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them (the dim
    sharded over their product, the first the major one) or None; trailing
    Nones dropped. The reference's ``PartitionSpec`` with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes only, for spec derivation with no
    processes (``jax.sharding.AbstractMesh(sizes, names)``'s counterpart)."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class MeshEnv:
    """A mesh plus the logical→physical rules to use inside it."""

    mesh: Optional[object]  # DeviceMesh, AbstractMesh or None
    rules: dict[str, MeshAxes] = field(default_factory=dict)

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def shape(self) -> dict:
        return mesh_shape(self.mesh)

    def axis_size(self, name: str) -> int:
        assert self.mesh is not None
        return self.shape[name]


def null_env() -> MeshEnv:
    """Environment with no mesh: all sharding helpers become no-ops."""
    return MeshEnv(mesh=None, rules={})


class _EnvStack(threading.local):
    def __init__(self):
        self.stack: list[MeshEnv] = []


_ENVS = _EnvStack()


def current_env() -> MeshEnv:
    if _ENVS.stack:
        return _ENVS.stack[-1]
    return null_env()


@contextlib.contextmanager
def use_env(env: MeshEnv):
    """Install a MeshEnv for the dynamic extent. With a device mesh, plain
    tensors meeting DTensors there count as replicated constants."""
    _ENVS.stack.append(env)
    try:
        if env.mesh is not None and not isinstance(env.mesh, AbstractMesh):
            with _implicit_replication():
                yield env
        else:
            yield env
    finally:
        _ENVS.stack.pop()


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``, but
    nestable: it restores the flag it found (the library's sets it False
    on exit, which would end an outer env's)."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def _mesh_axes_tuple(mesh_axes: MeshAxes) -> tuple:
    if mesh_axes is None:
        return ()
    if isinstance(mesh_axes, str):
        return (mesh_axes,)
    return tuple(mesh_axes)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    env: Optional[MeshEnv] = None,
    shape: Optional[Sequence[int]] = None,
) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec under env's rules.

    A mesh axis may appear at most once in a spec; later occurrences are
    dropped. If ``shape`` is given, mesh axes whose size does not divide the
    dim are dropped too (kv_heads=4 on model=16 stays replicated)."""
    env = env or current_env()
    if not env.active:
        return P()
    sizes = env.shape
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical_axes):
        mesh_axes = _mesh_axes_tuple(env.rules.get(name)) if name else ()
        picked = []
        size = 1
        for ax in mesh_axes:
            if ax in used or ax not in sizes:
                continue
            picked.append(ax)
            size *= sizes[ax]
        if shape is not None and picked and shape[i] % size != 0:
            # Try progressively shorter prefixes of the axis tuple.
            while picked:
                picked.pop()
                size = 1
                for ax in picked:
                    size *= sizes[ax]
                if size == 1 or shape[i] % size == 0:
                    break
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def spec_entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_to_placements(spec: PartitionSpec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim, in mesh order: the
    dim d whose spec entry names that axis. A dim sharded over several axes
    is split by them in mesh-dim order (DTensor's rule); the reference splits
    it in the entry's order. The two agree wherever the entry lists the axes
    in mesh order, as every rule does; ZeRO-1's appended DP axes do not
    (``parallel.zero``, ROADMAP C.17): the shard shapes agree, which block a
    device holds does not. A mesh dim of size 1 is Replicate whatever the
    spec says (DTensor cannot reshape a dim of size 1 that it calls
    sharded)."""
    sizes = mesh_shape(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in spec_entry_axes(entry):
            if sizes[ax] > 1:  # a shard over one device is the whole tensor
                out[names.index(ax)] = Shard(d)
    return tuple(out)


def shard_shape(spec: PartitionSpec, shape, mesh) -> tuple:
    """Each device's local shape of a ``shape`` tensor under ``spec`` (the
    reference's ``NamedSharding.shard_shape``; every dim divides evenly)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in spec_entry_axes(entry):
            out[d] //= sizes[ax]
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the reference's ``NamedSharding``."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        return shard_shape(self.spec, shape, self.mesh)


def _norm(placements, mesh) -> tuple:
    """Placements with those of size-1 mesh dims read as Replicate (a shard
    over one device is the whole tensor)."""
    return tuple(Replicate() if mesh.size(i) == 1 else p
                 for i, p in enumerate(placements))


def placements_equal(a, b, mesh) -> bool:
    return _norm(a, mesh) == _norm(b, mesh)


def shard(x, *logical_axes: Optional[str]):
    """The reference's with_sharding_constraint: under an active env, x (a
    DTensor) redistributed to the spec of its logical axes; with no env, x
    as it is. A plain tensor under an active env raises."""
    env = current_env()
    if not env.active:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"shard{logical_axes}: a plain tensor of shape {tuple(x.shape)} under an "
            "active mesh env; the sharded path computes on DTensors only")
    spec = logical_to_spec(logical_axes, env, shape=x.shape)
    want = spec_to_placements(spec, env.mesh)
    if placements_equal(x.placements, want, env.mesh):
        return x
    return x.redistribute(env.mesh, want)


def batch_only(x):
    """x with every mesh dim but those that split its batch (dim 0) made
    whole: partial sums reduced, other splits gathered; a plain tensor as it
    is. Placed where a (B, S, ...) activation enters or leaves a product:
    DTensor (torch 2.11) cannot flatten (B, S) for a product while S
    is split, forward or backward (the ``--sp`` residual, the token-parallel
    MoE's output), and a redistribute here puts the gradient back as it
    came. Where x is batch-only already, its gradient is pinned to that
    (``pin_grad``): a gradient that came back split on the sequence would
    make the product's backward flatten a split (B, S), which torch 2.13's
    DTensor plans for minutes on a 3-D mesh (the dry-run's 2x2x2 cells)."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return pin_grad(x) if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def gather_dim(x, dim: int):
    """x with its dim ``dim`` whole on every rank (an all-gather where a
    DTensor splits it), every other placement kept; a plain tensor as it is
    (``batch_only``'s reason, for an activation split on its heads or MLP
    width as well)."""
    if not isinstance(x, DTensor) or Shard(dim) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if p == Shard(dim) else p
                                               for p in x.placements))


def heads_whole(x, dim: int, n_heads: int):
    """x with its dim ``dim`` gathered (``gather_dim``) where the dim's split
    does not keep each of its ``n_heads`` heads whole on one rank, ahead of
    a reshape of the dim into (n_heads, width / n_heads): DTensor cannot
    unflatten a dim whose split does not divide the heads (recurrentgemma's
    10 heads, xlstm's 4, on a 16-way ``model`` axis), where XLA reshards it.
    A plain tensor, or a split into whole heads, as it is."""
    if not isinstance(x, DTensor):
        return x
    ways = 1
    for i, p in enumerate(x.placements):
        if p == Shard(dim % x.dim()):
            ways *= x.device_mesh.size(i)
    return x if n_heads % ways == 0 else gather_dim(x, dim % x.dim())


def batch_heads_placements(x) -> tuple:
    """A (B, H, ...) DTensor's splits of batch (dim 0) and heads (dim 1);
    every other split, every partial sum and every size-1 mesh dim made
    whole: the placements under which each rank's local shard holds whole
    (batch row, head) problems."""
    mesh = x.device_mesh
    return tuple(q if isinstance(q, Shard) and q.dim in (0, 1) and mesh.size(i) > 1
                 else Replicate() for i, q in enumerate(x.placements))


def batch_heads(x):
    """x redistributed to ``batch_heads_placements`` (partial sums reduced,
    other splits gathered); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    want = batch_heads_placements(x)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def pin_grad(x):
    """x as it is, with its gradient brought to x's own placements on the
    way back (the backward of ``DTensor.from_local`` redistributes it): put
    after a reshape that merged whole heads (``heads_whole``), whose
    backward splits the dim again and cannot take a gradient that a later
    product left split unevenly. A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def placed_as(t, like):
    """``t`` redistributed to ``like``'s placements (a DTensor of ``like``'s
    rank), or ``t`` as it is."""
    if not isinstance(t, DTensor) or placements_equal(t.placements, like.placements,
                                                      t.device_mesh):
        return t
    return t.redistribute(t.device_mesh, like.placements)


def place(t: torch.Tensor, sharding: Optional[NamedSharding]):
    """``t`` (whole, the same on every rank) as a DTensor with ``sharding``:
    each rank keeps its own block, with no communication (the reference's
    ``device_put``). ``sharding`` None gives ``t`` back."""
    if sharding is None:
        return t
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh, placements = sharding.mesh, sharding.placements
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, placements)
    if tuple(shape) != tuple(t.shape):  # a copy, not a view that keeps t alive
        t_local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        local = t_local.clone(memory_format=torch.contiguous_format)
    else:
        local = t
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def place_abstract(tree, shardings):
    """Each leaf of ``tree`` (a ``params.ShapeDtype`` or anything with a
    shape and a dtype) as a DTensor of its global shape over an empty meta
    local shard of ``shard_shape`` under the same-path leaf of
    ``shardings``: nothing is allocated, sliced or gathered, so a 235 B-param
    state costs nothing (the dry-run's). A None sharding (or ``shardings``
    None: no mesh) gives a plain meta tensor."""
    by_path = {} if shardings is None else dict(tree_flatten_with_paths(shardings))

    def one(path, leaf):
        sharding = by_path.get(path)
        if sharding is None:
            return torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")
        local = torch.empty(sharding.shard_shape(leaf.shape), dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                                  shape=torch.Size(leaf.shape),
                                  stride=contiguous_stride(leaf.shape))

    return tree_map_with_path(one, tree)


def resolve_spec(axes_leaf, shape, env: Optional[MeshEnv] = None) -> PartitionSpec:
    """PartitionSpec for one parameter given its logical axes and shape."""
    return logical_to_spec(axes_leaf, env=env, shape=shape)


def _is_axes(leaf) -> bool:
    """A leaf of an axes tree: a plain tuple of names (or None), as the
    reference's ``is_leaf``; a tuple of such tuples (whisper's ``cross_kv``)
    is a node."""
    return isinstance(leaf, tuple) and not hasattr(leaf, "_fields") and \
        all(isinstance(x, (str, type(None))) for x in leaf)


def map_axes(fn, axes_tree, shapes_tree):
    """``fn(axes, leaf)`` over an axes tree (tuples of logical names at the
    leaves) and a same-structured tree of leaves with a ``.shape``."""
    if _is_axes(axes_tree):
        return fn(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, shapes_tree[k]) for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(map_axes(fn, a, s)
                                 for a, s in zip(axes_tree, shapes_tree)))
    if isinstance(axes_tree, tuple):
        return tuple(map_axes(fn, a, s) for a, s in zip(axes_tree, shapes_tree))
    if isinstance(axes_tree, list):
        return [map_axes(fn, a, s) for a, s in zip(axes_tree, shapes_tree)]
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def param_shardings(axes_tree, shapes_tree, env: Optional[MeshEnv] = None):
    """NamedShardings for a parameter tree (None at every leaf with no env).

    ``axes_tree`` has the params' structure with tuples of logical names at
    the leaves; ``shapes_tree`` carries tensors or ``params.ShapeDtype``."""
    env = env or current_env()
    if not env.active:
        return map_axes(lambda _a, _s: None, axes_tree, shapes_tree)
    return map_axes(lambda axes, arr: NamedSharding(
        env.mesh, resolve_spec(tuple(axes), arr.shape, env)), axes_tree, shapes_tree)


__all__ = ["AbstractMesh", "MULTI_POD_RULES", "MeshEnv", "NamedSharding", "P", "batch_heads",
           "batch_heads_placements", "batch_only",
           "gather_dim", "heads_whole", "pin_grad", "placed_as",
           "PartitionSpec", "SINGLE_POD_RULES", "current_env",
           "contiguous_stride", "logical_to_spec", "map_axes", "mesh_shape", "null_env",
           "param_shardings", "place", "place_abstract", "placements_equal", "resolve_spec",
           "shard", "shard_shape", "spec_to_placements", "use_env", "zero1_rules"]
