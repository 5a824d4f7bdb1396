"""Step factories of the decoder-only LM and the encoder-decoder (whisper):
train and eval, prefill and decode; the train state's abstract form and its
shardings on a mesh.

Under an active mesh env (``parallel.use_env``) the same steps run on
DTensors: the params and the ZeRO-1 optimizer state placed by
``train_state_shardings``, the batch by ``data.pipeline.shard_batch``."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.models import encdec, lm
from repro_torch.nn import params as prm
from repro_torch.nn.blocks import init_stack_state, stack_state_axes
from repro_torch.optim import adamw
from repro_torch.parallel import current_env
from repro_torch.parallel.sharding import NamedSharding, P, gather_dim, param_shardings, place
from repro_torch.parallel.zero import opt_state_shardings
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map_with_path, tree_unflatten


class TrainState(NamedTuple):
    step: torch.Tensor  # () int32
    params: dict
    opt: adamw.OptState


AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def model_defs(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return encdec.def_encdec(cfg)
    return lm.def_lm(cfg)


def init_params(cfg: ModelConfig, seed: int, device="cpu"):
    return prm.materialize(seed, model_defs(cfg), prm.torch_dtype(cfg.dtype),
                           device)


def param_axes(cfg: ModelConfig):
    """The params' logical axes: a tuple of names at each leaf."""
    return prm.axes_of(model_defs(cfg))


def abstract_params(cfg: ModelConfig):
    return prm.abstract(model_defs(cfg), prm.torch_dtype(cfg.dtype))


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """The train state's leaves as ``ShapeDtype`` (restore's ``like``)."""
    params = abstract_params(cfg)
    return TrainState(prm.ShapeDtype((), torch.int32), params, adamw.abstract_state(params))


def train_state_shardings(cfg: ModelConfig, env) -> TrainState:
    """NamedShardings of the train state on ``env``'s mesh: the step
    replicated, the params by their logical axes, the optimizer state by
    ZeRO-1 (the reference's train CLI's ``st_sh``)."""
    aparams, axes = abstract_params(cfg), param_axes(cfg)
    return TrainState(NamedSharding(env.mesh, P()), param_shardings(axes, aparams, env),
                      opt_state_shardings(axes, aparams, env))


def place_tree(tree, shardings):
    """Each leaf of ``tree`` (whole, the same on every rank) placed with the
    same-path leaf of ``shardings`` (``parallel.sharding.place``)."""
    by_path = dict(tree_flatten_with_paths(shardings))
    return tree_map_with_path(lambda path, t: place(t, by_path[path]), tree)


def decode_state_axes(cfg: ModelConfig):
    """The decode state's logical axes: the stack's, or an
    encoder-decoder's (``encdec.decode_state_axes``)."""
    return encdec.decode_state_axes(cfg) if cfg.is_encoder_decoder else stack_state_axes(cfg)


def decode_state_shardings(cfg: ModelConfig, states, env):
    """NamedShardings of a decode state on ``env``'s mesh, from its logical
    axes (the KV cache's ``kv_seq`` axis is what ``ctx_parallel``
    shards)."""
    return param_shardings(decode_state_axes(cfg), states, env)


def greedy(logits):
    """The greedy next token (B, 1) of (B, S, V) logits' last position. On a
    mesh the last position's vocab is gathered first: DTensor's argmax over
    a split vocab fails on a (pod, data, model) mesh (torch 2.13's
    all-gather of the per-shard winners, found by the dry-run's 2x16x16
    prefill), and the gather moves only B x V values."""
    return torch.argmax(gather_dim(logits[:, -1:], 2), dim=-1)


def make_prefill_step(cfg: ModelConfig, force=None):
    """Returns fn(params, batch) → (next_token (B,1), states, last_logits).

    ``force`` goes to ``kernels.ops.flash_attention`` and
    ``kernels.ops.rglru_scan`` ("ref" runs both plain versions, to hold the
    kernels' path against them; an xlstm model reaches neither). An
    encoder-decoder's batch holds ``frames`` too: it encodes them, runs the
    teacher-forced decoder over the tokens and returns (next token, the
    memory, last logits), as the reference does."""

    if cfg.is_encoder_decoder:
        def prefill(params, batch):
            memory = encdec.encode(params, batch["frames"], cfg, force=force)
            logits = encdec.decode_train(params, batch["tokens"], memory, cfg, force=force)
            return greedy(logits), memory, logits[:, -1]
        return prefill

    def prefill(params, batch):
        logits, states = lm.lm_apply(params, batch["tokens"], cfg,
                                     mode="prefill", force=force)
        return greedy(logits), states, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """Returns fn(params, token (B,1), states, cache_len int) →
    (next_token (B,1), states); ``states`` is updated in place (an
    encoder-decoder's from ``encdec.init_decode_state``)."""

    if cfg.is_encoder_decoder:
        def decode(params, token, states, cache_len):
            logits, new_states = encdec.decode_step(params, token, states, cache_len, cfg)
            return greedy(logits), new_states
        return decode

    def decode(params, token, states, cache_len):
        logits, new_states = lm.lm_apply(params, token, cfg, mode="decode",
                                         states=states, cache_len=cache_len)
        return greedy(logits), new_states

    return decode


def decode_state(cfg: ModelConfig, batch: int, s_max: int, device="cpu"):
    """Zeroed decode-time state at capacity ``s_max``: a KV cache per
    attention block; a {"conv", "h"} dict per rglru block; a {"conv",
    "state"} dict per mlstm block (``MLSTMState``: C, n, m) and per slstm
    block (``SLSTMState``: c, n, m, h), the recurrent states fp32. An
    encoder-decoder's needs the params and the memory: it raises, as the
    reference's does."""
    if cfg.is_encoder_decoder:
        raise ValueError("enc-dec decode state needs params+memory; "
                         "use encdec.init_decode_state")
    return init_stack_state(cfg, batch, s_max, prm.torch_dtype(cfg.dtype),
                            device)


def abstract_decode_state(cfg: ModelConfig, batch: int, s_max: int):
    """The decode state's leaves as ``params.ShapeDtype`` (no allocation).
    A local-attention cache is ``compact``: bounded at its window + 1, so
    that ``long_500k`` states the arch's memory, not a 500k cache's."""
    dtype = prm.torch_dtype(cfg.dtype)
    if cfg.is_encoder_decoder:
        return encdec.abstract_decode_state(cfg, batch, s_max, dtype)
    state = init_stack_state(cfg, batch, s_max, dtype, "meta", compact=True)
    return tree_map_with_path(lambda _, t: prm.ShapeDtype(tuple(t.shape), t.dtype), state)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Every model input of an (arch, shape) cell as ``params.ShapeDtype``:
    train and prefill a token batch (int32, as the reference's; the steps
    take any integer type), with ``frames`` for an encoder-decoder; decode
    one token a sequence, the whole decode state at capacity ``seq_len``
    and ``cache_len`` (a 0-d int32)."""
    b, s = shape.global_batch, shape.seq_len

    def tok(*sh):
        return prm.ShapeDtype(sh, torch.int32)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": tok(b, s)}
        if shape.kind == "train":
            batch["labels"] = tok(b, s)
        if cfg.is_encoder_decoder:
            batch["frames"] = prm.ShapeDtype((b, cfg.enc_seq, cfg.d_model),
                                             prm.torch_dtype(cfg.dtype))
        return {"batch": batch}
    return {"token": tok(b, 1), "states": abstract_decode_state(cfg, b, s),
            "cache_len": prm.ShapeDtype((), torch.int32)}


def init_train_state(cfg: ModelConfig, seed: int, device="cpu") -> TrainState:
    params = init_params(cfg, seed, device)
    return TrainState(torch.zeros((), dtype=torch.int32, device=device), params,
                      adamw.init(params))


def _batch_on(batch, device):
    """The batch's arrays (numpy or tensors) as tensors on ``device``: the
    integer ``tokens`` and ``labels`` as int64, floating ``frames`` in their
    own dtype. Under an active mesh env, DTensors placed by ``shard_batch``
    (a batch of DTensors is taken as it is)."""
    env = current_env()
    if env.active:
        return shard_batch(batch, env, device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device) if t.is_floating_point() else t.to(device, torch.long)
    return out


def loss_fn(params, batch, cfg: ModelConfig, force=None):
    """(ce + AUX_WEIGHT·aux, {"ce", "aux"}) of one batch of tokens/labels
    (and, for an encoder-decoder, ``frames``, whose aux is 0)."""
    if cfg.is_encoder_decoder:
        memory = encdec.encode(params, batch["frames"], cfg, force=force)
        logits = encdec.decode_train(params, batch["tokens"], memory, cfg, force=force)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    else:
        logits, aux = lm.lm_apply(params, batch["tokens"], cfg, mode="train", force=force)
    ce = lm.cross_entropy(logits, batch["labels"])
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, force=None):
    """Returns fn(state, batch) → (new_state, metrics): the loss and its
    gradients by autograd (through the kernels' backwards on the card:
    flash attention's and the RG-LRU scan's), then AdamW. ``metrics`` holds
    0-d tensors ``loss, ce, aux, grad_norm, lr`` and ``step`` (the step the
    update was taken at). ``force`` goes to ``kernels.ops``; ``"ref"`` runs
    the plain versions. The step consumes ``state``, as the reference's
    train CLI donates its jitted step's: the params and the optimizer state
    are updated in place (the functional update's bits), so a step holds
    one copy of the fp32 optimizer state, not two (recurrentgemma-2b's take
    32 GB)."""

    def train_step(state: TrainState, batch):
        flat = tree_flatten_with_paths(state.params)
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        params = tree_unflatten({path: t for (path, _), t in zip(flat, leaves)})
        batch = _batch_on(batch, leaves[0].device)
        with torch.enable_grad():
            loss, parts = loss_fn(params, batch, cfg, force=force)
            grads = torch.autograd.grad(loss, leaves)
        grads = tree_unflatten({path: g for (path, _), g in zip(flat, grads)})
        new_params, new_opt, om = adamw.update(opt_cfg, grads, state.opt, state.step,
                                               donate=state.params)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()},
                   **om, "step": state.step}
        metrics = {k: _whole(v) for k, v in metrics.items()}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step


def _whole(t):
    """A replicated DTensor metric as a plain tensor (plain ones as they are)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_eval_step(cfg: ModelConfig, force=None):
    @torch.no_grad()
    def eval_step(params, batch):
        batch = _batch_on(batch, tree_flatten_with_paths(params)[0][1].device)
        loss, parts = loss_fn(params, batch, cfg, force=force)
        return {"loss": loss, **parts}

    return eval_step
