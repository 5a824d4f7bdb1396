"""Load the JAX package's parameters into the port.

The input is a flat ``{path: np.ndarray}`` dict keyed by '/'-joined leaf
paths, as the reference's ``tree_flatten_with_paths`` + ``np.asarray``
give it. bf16 arrays are reinterpreted bit for bit (``view(np.uint16)`` →
torch → ``view(torch.bfloat16)``), so no numpy bf16 extension is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.steps import model_defs
from repro_torch.nn import params as prm
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_numpy(flat: dict, cfg: ModelConfig, device) -> dict:
    """Port param tree on ``device`` from ``flat``. Raises ValueError unless
    the paths, shapes and dtypes equal the port's own def-tree for ``cfg``."""
    want = dict(tree_flatten_with_paths(model_defs(cfg)))
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"param paths differ: missing {missing}, extra {extra}")
    default = prm.torch_dtype(cfg.dtype)
    out = {}
    for path, d in want.items():
        t = _to_tensor(flat[path])
        dtype = prm.leaf_dtype(d, default)
        if tuple(t.shape) != tuple(d.shape) or t.dtype != dtype:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {tuple(d.shape)} {dtype}")
        out[path] = t.to(device)
    return tree_unflatten(out)
