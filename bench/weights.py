"""The seeded weights both sides are given, and the layout contract between
the port's parameter tree and the reference's.

A parameter kind (``embed``, ``wq``, ``e_up``, ...) is one flat draw of all
its layers from its own generator on the device, seeded from ``--seed`` and
the kind's name: ``torch.randn`` in the leaf's own dtype, times the kind's
std. Each side views the same values in its own shape, so the port's
stacked ``blocks/scan/attn/wq`` (layers, d, heads, head_dim) and the
reference's (layers, d, heads * head_dim) hold the same numbers in the same
order, and an unstacked ``blocks/layers/<i>/attn/wq`` is layer i's slice.

Std: 0.02 for the embedding, 1/sqrt(true fan-in) for every projection (the
product of its input dims: d into q, k, v, the MLP, the router and each
expert; heads x head_dim into the attention's output; d_ff into the down
projections). The port's own init divides by the size of one axis (the
heads axis for the attention projections), which makes a random network
chaotic at depth: two correct paths that round differently end in
unrelated logits. Norm scales are 1.
"""

from __future__ import annotations

import math
import zlib

import torch

from bench.flops import dims

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def kinds(cfg: dict) -> dict:
    """{kind: (port subpath, per-layer shape or None for a whole-model leaf,
    std or None for ones, dtype name)} of a configuration file."""
    w = dims(cfg)
    d, h, kv, hd, ff, e = w["d"], w["h"], w["kv"], w["hd"], w["ff"], w["experts"]
    dt = cfg["torch_dtype"]
    out = {
        "embed": ("embed", None, 0.02, dt),
        "final_norm": ("final_norm/scale", None, None, "float32"),
        "attn_norm": ("norm1/scale", (d,), None, "float32"),
        "wq": ("attn/wq", (d, h, hd), d ** -0.5, dt),
        "wk": ("attn/wk", (d, kv, hd), d ** -0.5, dt),
        "wv": ("attn/wv", (d, kv, hd), d ** -0.5, dt),
        "wo": ("attn/wo", (h, hd, d), (h * hd) ** -0.5, dt),
        "ffn_norm": ("norm2/scale", (d,), None, "float32"),
    }
    if e:
        out.update({
            "router": ("moe/router", (d, e), d ** -0.5, "float32"),
            "e_gate": ("moe/gate", (e, d, ff), d ** -0.5, dt),
            "e_up": ("moe/up", (e, d, ff), d ** -0.5, dt),
            "e_down": ("moe/down", (e, ff, d), ff ** -0.5, dt),
        })
    else:
        out.update({
            "w_gate": ("mlp/gate", (d, ff), d ** -0.5, dt),
            "w_up": ("mlp/up", (d, ff), d ** -0.5, dt),
            "w_down": ("mlp/down", (ff, d), ff ** -0.5, dt),
        })
    return out


def whole_shape(cfg: dict, kind: str) -> tuple:
    """A kind's shape over all layers (the port's stacked leaf)."""
    _, shape, _, _ = kinds(cfg)[kind]
    w = dims(cfg)
    if shape is None:
        return (w["vocab"], w["d"]) if kind == "embed" else (w["d"],)
    return (w["layers"], *shape)


def kind_seed(seed: int, kind: str) -> int:
    """A kind's generator seed: the run's seed and the crc32 of its name."""
    return (seed * 1_000_003 + zlib.crc32(kind.encode())) % (2 ** 63)


def draw(cfg: dict, kind: str, seed: int, device) -> torch.Tensor:
    """The kind's values over all layers, flat, in its own dtype."""
    _, _, std, dt = kinds(cfg)[kind]
    n = math.prod(whole_shape(cfg, kind))
    dtype = _DTYPES[dt]
    if std is None:
        return torch.ones(n, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(kind_seed(seed, kind))
    return torch.randn(n, generator=gen, dtype=dtype, device=device).mul_(std)


def port_path(cfg: dict, kind: str) -> str:
    """The port's leaf path of a kind: its attention stack's layers are
    stacked into one leaf a kind (``blocks/scan/...``)."""
    sub, shape, _, _ = kinds(cfg)[kind]
    return sub if shape is None else f"blocks/scan/{sub}"


def kind_of_path(cfg: dict, path: str) -> str:
    """The kind a port leaf path belongs to."""
    for kind in kinds(cfg):
        if port_path(cfg, kind) == path:
            return kind
    raise KeyError(f"no parameter kind for the port's leaf {path!r}")


# elements of a kind's gradient sampled for the elementwise comparison
SAMPLE = 1 << 20


def sample_index(cfg: dict, kind: str, seed: int, device) -> torch.Tensor:
    """Sorted flat indices of a kind's elements (all of them where it has
    fewer than SAMPLE), drawn from the seed and the kind's name."""
    n = math.prod(whole_shape(cfg, kind))
    if n <= SAMPLE:
        return torch.arange(n, device=device)
    gen = torch.Generator(device=device).manual_seed(kind_seed(seed, kind + "/sample"))
    return torch.sort(torch.randint(0, n, (SAMPLE,), generator=gen, device=device)).values


def gather(parts: list, index: torch.Tensor) -> torch.Tensor:
    """The elements at ``index`` of the parts' flat concatenation (a kind's
    leaves in layer order), as float64."""
    out, at = [], 0
    for part in parts:
        flat = part.reshape(-1)
        lo, hi = torch.searchsorted(index, torch.tensor([at, at + flat.numel()],
                                                        device=index.device)).tolist()
        out.append(flat[index[lo:hi] - at].double())
        at += flat.numel()
    return torch.cat(out)
