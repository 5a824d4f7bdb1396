"""Parameter definition & materialization.

Layers declare parameters as trees of :class:`ParamDef` (shape + logical
axes + initializer); ``materialize`` turns a def-tree into tensors. Every
leaf is drawn in fp32 from its own CPU ``torch.Generator``, seeded from the
model seed and the crc32 of the leaf's path, then cast and moved: the same
seed gives the same weights on the CPU and on the card, whatever order the
tree is walked in. The values differ from ``jax.random``'s, so parity
tests load the reference's params (``repro_torch.convert``).
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional

import torch

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


def _init_leaf(gen: torch.Generator, d: ParamDef, default_dtype: torch.dtype,
               device) -> torch.Tensor:
    dtype = leaf_dtype(d, default_dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "normal":
        std = d.scale if d.scale is not None else 0.02
    elif d.init == "scaled_fan_in":
        scale = d.scale if d.scale is not None else 1.0
        std = scale / math.sqrt(max(_fan_in(d.shape), 1))
    else:
        raise ValueError(f"unknown init {d.init}")
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32)
    return (std * x).to(device=device, dtype=dtype)


def leaf_seed(seed: int, path: str) -> int:
    """Per-leaf seed: the leaf path's crc32 folded into the model seed
    (crc32, not hash(): Python salts str hashes per process)."""
    return seed * 2**31 + zlib.crc32(path.encode()) % (2**31)


def materialize(seed: int, defs, dtype: torch.dtype = torch.bfloat16,
                device="cpu"):
    """Turn a ParamDef tree into a tree of tensors on ``device``."""

    def build(path: str, d: ParamDef):
        gen = torch.Generator(device="cpu").manual_seed(leaf_seed(seed, path))
        return _init_leaf(gen, d, dtype, device)

    return tree_map_with_path(build, defs)


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
