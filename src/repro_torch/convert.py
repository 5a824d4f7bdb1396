"""Load the JAX package's parameters, or a whole train state, into the
port.

The input is a flat ``{path: np.ndarray}`` dict keyed by '/'-joined leaf
paths, as the reference's ``tree_flatten_with_paths`` + ``np.asarray``
give it (a checkpoint's ``restore`` gives the same keys, as tensors).
bf16 arrays are reinterpreted bit for bit (``view(np.uint16)`` → torch →
``view(torch.bfloat16)``), so no numpy bf16 extension is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.steps import TrainState, model_defs
from repro_torch.nn import params as prm
from repro_torch.optim.adamw import OptState
from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten


def _to_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr, order="C")  # keeps a 0-d array 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _load(flat: dict, want: dict, device) -> dict:
    """{path: tensor on device} of ``flat``, whose paths must be those of
    ``want`` ({path: (shape, dtype)}) with those shapes and dtypes."""
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"paths differ: missing {missing}, extra {extra}")
    out = {}
    for path, (shape, dtype) in want.items():
        t = _to_tensor(flat[path])
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {tuple(shape)} {dtype}")
        out[path] = t.to(device)
    return out


def _param_specs(cfg: ModelConfig) -> dict:
    default = prm.torch_dtype(cfg.dtype)
    return {path: (tuple(d.shape), prm.leaf_dtype(d, default))
            for path, d in tree_flatten_with_paths(model_defs(cfg))}


def params_from_numpy(flat: dict, cfg: ModelConfig, device) -> dict:
    """Port param tree on ``device`` from ``flat``. Raises ValueError unless
    the paths, shapes and dtypes equal the port's own def-tree for ``cfg``."""
    return tree_unflatten(_load(flat, _param_specs(cfg), device))


def train_state_from_numpy(flat: dict, cfg: ModelConfig, device) -> TrainState:
    """Port ``TrainState`` on ``device`` from the flat leaves of a whole
    reference train state: ``step`` (0-d int32), ``params/…`` and the fp32
    ``opt/m/…``, ``opt/v/…``, ``opt/master/…``. Raises ValueError unless
    the paths, shapes and dtypes equal the port's own tree for ``cfg``."""
    params = _param_specs(cfg)
    want = {"step": ((), torch.int32)}
    want.update({f"params/{p}": spec for p, spec in params.items()})
    for part in OptState._fields:
        want.update({f"opt/{part}/{p}": (shape, torch.float32)
                     for p, (shape, _) in params.items()})
    out = _load(flat, want, device)
    sub = lambda prefix: tree_unflatten(  # noqa: E731
        {p[len(prefix):]: t for p, t in out.items() if p.startswith(prefix)})
    return TrainState(out["step"], sub("params/"),
                      OptState(*(sub(f"opt/{part}/") for part in OptState._fields)))
