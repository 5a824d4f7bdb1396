"""Dense MLP blocks: SwiGLU (llama family) and GELU (whisper)."""

from __future__ import annotations

import torch

from repro_torch.nn import params as prm
from repro_torch.nn.layers import activation
from repro_torch.nn.policy import interior_einsum
from repro_torch.parallel import shard
from repro_torch.parallel.sharding import batch_only, gather_dim


def def_mlp(d_model: int, d_ff: int, act: str = "silu"):
    """SwiGLU (``gate`` leaf) for silu, ungated otherwise. The reference's
    ``use_bias`` (``up_b``/``down_b``) is set by no config, so it is not
    ported."""
    d = {
        "up": prm.matrix(d_model, d_ff, "embed", "mlp"),
        "down": prm.matrix(d_ff, d_model, "mlp", "embed"),
    }
    if act == "silu":
        d["gate"] = prm.matrix(d_model, d_ff, "embed", "mlp")
    return d


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU where the tree has a gate, else act(up); the activation (and
    the gating product) run in fp32. The reference keeps the up/gate
    products in fp32 until then; here they come back in x's dtype first,
    which adds one bf16 rounding (fp32 is exact; ROADMAP C.8)."""
    x = batch_only(x)
    up = interior_einsum("...d,df->...f", x, p["up"])
    if "gate" in p:
        gate = interior_einsum("...d,df->...f", x, p["gate"])
        h = activation(act)(gate.float()) * up.float()
    else:
        h = activation(act)(up.float())
    h = gather_dim(shard(h.to(x.dtype), "batch", "seq", "mlp"), 1)  # --sp splits its seq
    return batch_only(interior_einsum("...f,fd->...d", h, p["down"]))
