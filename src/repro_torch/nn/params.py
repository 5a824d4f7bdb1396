"""Parameter definition & materialization.

Layers declare parameters as trees of :class:`ParamDef` (shape + logical
axes + initializer); ``materialize`` turns a def-tree into tensors. Every
leaf is drawn in fp32 from its own CPU ``torch.Generator``, seeded from the
model seed and the crc32 of the leaf's path, then cast and moved: the same
seed gives the same weights on the CPU and on the card, whatever order the
tree is walked in, and whichever thread draws a leaf. The values differ
from ``jax.random``'s, so parity tests load the reference's params
(``repro_torch.convert``).
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.utils.pool import imap_window
from repro_torch.utils.trees import tree_map_with_path

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple  # logical axis names, same length as shape (None allowed)
    init: str = "normal"  # normal | zeros | ones | scaled_fan_in
    scale: Optional[float] = None
    dtype: Optional[str] = None  # override model dtype (e.g. fp32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _fan_in(shape: tuple) -> int:
    # (in, out) matrices: dim 0; stacked (layers, in, out): dim -2.
    if len(shape) >= 2:
        return shape[-2]
    return 1


def leaf_dtype(d: ParamDef, default_dtype: torch.dtype) -> torch.dtype:
    return torch_dtype(d.dtype) if d.dtype else default_dtype


def _std(d: ParamDef) -> Optional[float]:
    """The std of a drawn leaf's init; None for a constant one."""
    if d.init in ("zeros", "ones"):
        return None
    if d.init == "normal":
        return d.scale if d.scale is not None else 0.02
    if d.init == "scaled_fan_in":
        scale = d.scale if d.scale is not None else 1.0
        return scale / math.sqrt(max(_fan_in(d.shape), 1))
    raise ValueError(f"unknown init {d.init}")


def _draw(seed: int, path: str, d: ParamDef) -> Optional[torch.Tensor]:
    """The leaf's N(0, 1) fp32 draw on the CPU (None for a constant leaf):
    one serial kernel, no thread team, no GIL."""
    if _std(d) is None:
        return None
    gen = torch.Generator(device="cpu").manual_seed(leaf_seed(seed, path))
    return torch.randn(d.shape, generator=gen, dtype=torch.float32)


def _init_leaf(x: Optional[torch.Tensor], d: ParamDef, default_dtype: torch.dtype,
               device) -> torch.Tensor:
    dtype = leaf_dtype(d, default_dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    return (_std(d) * x).to(device=device, dtype=dtype)


def leaf_seed(seed: int, path: str) -> int:
    """Per-leaf seed: the leaf path's crc32 folded into the model seed
    (crc32, not hash(): Python salts str hashes per process)."""
    return seed * 2**31 + zlib.crc32(path.encode()) % (2**31)


# fp32 draws in flight at once: a full-width model's weights are drawn on
# every core, two of llama3-8b's largest leaves at a time. A tree whose
# draws come to less than DRAW_POOL_MIN_BYTES (a tiny config's) is drawn on
# the calling thread: handing its leaves to threads would cost more.
DRAW_WINDOW_BYTES = 16 << 30
DRAW_POOL_MIN_BYTES = 64 << 20


def _draw_bytes(args) -> int:
    return 4 * math.prod(args[2].shape)


def materialize(seed: int, defs, dtype: torch.dtype = torch.bfloat16,
                device="cpu"):
    """Turn a ParamDef tree into a tree of tensors on ``device``. The
    leaves' draws run on a pool of threads (``imap_window``, at most
    DRAW_WINDOW_BYTES of them in flight); the calling thread scales, casts
    and moves each leaf, in the tree's order."""
    order = []
    tree_map_with_path(lambda path, d: order.append((seed, path, d)), defs)
    if sum(map(_draw_bytes, order)) < DRAW_POOL_MIN_BYTES:
        drawn = (_draw(*a) for a in order)
    else:
        drawn = imap_window(_draw, order, _draw_bytes, DRAW_WINDOW_BYTES)
    return tree_map_with_path(lambda _, d: _init_leaf(next(drawn), d, dtype, device), defs)


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype, with no storage (``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def abstract(defs, dtype: torch.dtype = torch.bfloat16):
    """ShapeDtype tree for a ParamDef tree (no allocation)."""
    return tree_map_with_path(lambda _, d: ShapeDtype(tuple(d.shape), leaf_dtype(d, dtype)),
                              defs)


def axes_of(defs):
    """Logical-axes tree (leaves = tuples) mirroring the params tree."""
    return tree_map_with_path(lambda _, d: tuple(d.axes), defs)


# --- declaration helpers --------------------------------------------------


def matrix(d_in: int, d_out: int, ax_in: str, ax_out: str, **kw) -> ParamDef:
    return ParamDef((d_in, d_out), (ax_in, ax_out), init="scaled_fan_in", **kw)


def bias(d: int, ax: str) -> ParamDef:
    return ParamDef((d,), (ax,), init="zeros")


def norm_scale(d: int, ax: str = "embed") -> ParamDef:
    # Norm scales stay fp32 for numerical robustness.
    return ParamDef((d,), (ax,), init="ones", dtype="float32")


def embedding(vocab: int, d: int) -> ParamDef:
    return ParamDef((vocab, d), ("vocab", "embed"), init="normal", scale=0.02)
