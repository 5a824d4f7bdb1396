"""Serve-step factories for the decoder-only LM: prefill and decode."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.nn import params as prm
from repro_torch.nn.blocks import init_stack_state


def model_defs(cfg: ModelConfig):
    return lm.def_lm(cfg)


def init_params(cfg: ModelConfig, seed: int, device="cpu"):
    return prm.materialize(seed, model_defs(cfg), prm.torch_dtype(cfg.dtype),
                           device)


def make_prefill_step(cfg: ModelConfig, force=None):
    """Returns fn(params, batch) → (next_token (B,1), states, last_logits).

    ``force`` goes to ``kernels.ops.flash_attention`` and
    ``kernels.ops.rglru_scan`` ("ref" runs both plain versions, to hold the
    kernels' path against them)."""

    def prefill(params, batch):
        logits, states = lm.lm_apply(params, batch["tokens"], cfg,
                                     mode="prefill", force=force)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        return nxt, states, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """Returns fn(params, token (B,1), states, cache_len int) →
    (next_token (B,1), states); ``states`` is updated in place."""

    def decode(params, token, states, cache_len):
        logits, new_states = lm.lm_apply(params, token, cfg, mode="decode",
                                         states=states, cache_len=cache_len)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        return nxt, new_states

    return decode


def decode_state(cfg: ModelConfig, batch: int, s_max: int, device="cpu"):
    """Zeroed decode-time state at capacity ``s_max``: a KV cache per
    attention block, a conv/h dict per recurrent block."""
    return init_stack_state(cfg, batch, s_max, prm.torch_dtype(cfg.dtype),
                            device)
