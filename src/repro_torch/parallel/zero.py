"""ZeRO-1: the optimizer state (Adam m/v and the fp32 master) sharded over
the DP axes (the reference's ``repro/parallel/zero.py``).

With pure DP the optimizer state is replicated, 12 fp32 bytes a param on
every device; ZeRO-1 cuts that by the DP degree. The DP mesh axes go into
the first dimension of each leaf that is not DP-sharded already and that
they divide, after any model axis there, else into a later dimension, else
nowhere (tiny scales and biases stay whole).

The train step (``models.steps``) then runs the reference's schedule by
hand: each gradient is reduced to its leaf's ZeRO-1 placement (a
reduce-scatter over DP), AdamW updates the sharded m, v and master, and the
new params are brought back to their own placement (an all-gather over DP).

The appended DP axes follow the model axis on the same dim, ``cur + dp``,
as in the reference; DTensor splits a dim in mesh-dim order instead
(``sharding.spec_to_placements``, ROADMAP C.17).
"""

from __future__ import annotations

from repro_torch.optim.adamw import OptState
from repro_torch.parallel.sharding import MeshEnv, NamedSharding, P, map_axes, resolve_spec


def _dp_axes(env: MeshEnv) -> tuple:
    axes = env.rules.get("batch") or ()
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in env.shape)


def zero1_spec(param_spec: P, shape, env: MeshEnv) -> P:
    """Insert the DP axes into the first divisible, DP-free dimension."""
    dp = _dp_axes(env)
    if not dp:
        return param_spec
    dp_size = 1
    for a in dp:
        dp_size *= env.axis_size(a)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    if any(a in used for a in dp):
        return param_spec  # already DP-sharded somehow
    for i, e in enumerate(entries):
        cur = tuple(a for a in (e if isinstance(e, tuple) else (e,)) if a)
        cur_size = 1
        for a in cur:
            cur_size *= env.axis_size(a)
        if shape[i] % (cur_size * dp_size) == 0:
            entries[i] = cur + dp if cur else (dp if len(dp) > 1 else dp[0])
            while entries and entries[-1] is None:
                entries.pop()
            return P(*entries)
    return param_spec


def opt_state_shardings(axes_tree, abstract_params, env: MeshEnv) -> OptState:
    """NamedShardings for OptState(m, v, master) with the ZeRO-1 axis."""
    def one(axes, arr):
        base = resolve_spec(tuple(axes), arr.shape, env)
        return NamedSharding(env.mesh, zero1_spec(base, arr.shape, env))

    tree = map_axes(one, axes_tree, abstract_params)
    return OptState(m=tree, v=tree, master=tree)
