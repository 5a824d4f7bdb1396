"""Serving engine + launcher: batched prefill + KV-cache decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 8 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --requests 8 --prompt-len 448 --gen 32

:class:`ServeEngine` is the importable core: one constructed engine is a
serving session (config resolved, params initialized on the device) that
:meth:`generate`\\ s batches on demand. The workloads serving tier of the
reference drives it in-process like its own engine: attach it to a
``Service`` through ``WorkloadPlane.attach_engine`` and each invoke lands
in :meth:`infer`. It runs on the card (``device="cuda"``) unless the
caller asks for another device; with no CUDA it raises.

With ``mesh="DxM"`` the engine serves on a (data, model) mesh of D*M
processes (``launch.mesh``; ``"1x1"`` in one process), each of which
constructs it and calls ``generate`` with the same prompts: the params
placed by their logical axes, the prompts split over ``data``, prefill on
DTensors (the flash kernel on each rank's local shards), and the decode
state placed by its logical axes (an encoder-decoder's frames, drawn the
same on every rank, split over ``data`` alike and encoded on local shards
first); ``ctx_parallel`` shards the KV cache's ``kv_seq`` over ``model``
(the reference's ``--ctx-parallel``). Decode attention stays plain
PyTorch, on DTensors; each decode step writes the new k/v in place into
each rank's local cache shard (only the rank that holds the position,
under ``ctx_parallel``). The tokens come back whole on every rank.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import mesh_env
from repro_torch.models import encdec, steps
from repro_torch.nn import params as prm
from repro_torch.nn.attention import KVCache
from repro_torch.parallel import param_shardings, use_env

PHASES = ("encode", "prefill", "decode")  # profiler ranges of ``generate``


def resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA card by default and none "
                           "is available; pass device='cpu' to run on the CPU")
    return dev


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """One in-process serving session for an arch.

    Construction is the expensive part (params on the device); ``generate``
    is the per-batch hot path: prefill → fixed-capacity KV cache (and
    recurrent states) → greedy decode, or for an encoder-decoder, encode →
    decode state → greedy decode.
    """

    def __init__(self, arch: str, tiny: bool = True, seed: int = 0,
                 device=None, params: Optional[dict] = None,
                 mesh: Optional[str] = None, ctx_parallel: bool = False):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # nn/policy.py: interior products accumulate in fp32.
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.arch = arch
        self.cfg = get_tiny_config(arch) if tiny else get_config(arch)
        self.env, self.device = mesh_env(mesh or "1", self.device,
                                         {"kv_seq": "model"} if ctx_parallel else None)
        self._gen = torch.Generator(device="cpu").manual_seed(seed)
        self.params = (params if params is not None
                       else steps.init_params(self.cfg, seed, self.device))
        if self.env.active:
            self.params = steps.place_tree(self.params, param_shardings(
                steps.param_axes(self.cfg), self.params, self.env))
        self._prefill = steps.make_prefill_step(self.cfg)
        self._decode = steps.make_decode_step(self.cfg)

    def synthetic_prompts(self, batch: int, prompt_len: int) -> torch.Tensor:
        """(batch, prompt_len) token ids drawn from the engine's generator."""
        return torch.randint(0, self.cfg.vocab_size, (batch, prompt_len),
                             generator=self._gen)

    # -- the per-batch hot path -------------------------------------------
    def generate(self, prompts, gen: int) -> dict:
        """Prefill ``prompts`` (B, S) and decode ``gen`` tokens. Returns
        ``{"tokens": (B, gen) CPU tensor, "prefill_s": float, "decode_s":
        float}``; throughput is the caller's division to do.

        An encoder-decoder (whisper) uses only the prompts' shape, as the
        reference does: it encodes (B, enc_seq, d_model) bf16 frames drawn
        from the engine's generator (the stub frontend), then decodes
        greedily from token 0 at position 0 against a decode state at
        capacity S + gen in the config's dtype (ROADMAP C.15);
        ``prefill_s`` is 0."""
        # DTensor's views cannot run in inference mode (a version counter)
        grad_off = torch.no_grad() if self.env.active else torch.inference_mode()
        with grad_off, use_env(self.env):
            return self._generate(prompts, gen)

    def _generate(self, prompts, gen: int) -> dict:
        prompts = shard_batch({"tokens": prompts}, self.env, self.device)["tokens"]
        B, S = prompts.shape
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            # drawn on the host from the engine's generator: the same frames
            # on every rank, each keeping its own rows
            frames = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=self._gen)
            frames = shard_batch({"frames": frames.to(torch.bfloat16)}, self.env,
                                 self.device)["frames"]
            with record_function("encode"):
                memory = encdec.encode(self.params, frames, cfg)
                _sync(self.device)
            states = encdec.init_decode_state(self.params, memory, cfg, B, S + gen,
                                              prm.torch_dtype(cfg.dtype))
            if self.env.active:
                states = steps.place_tree(states, steps.decode_state_shardings(
                    cfg, states, self.env))
            tok = torch.zeros((B, 1), dtype=torch.long, device=self.device)
            cache_len, t_pf = 0, 0.0
        else:
            t0 = time.perf_counter()
            with record_function("prefill"):
                tok, pf_states, _ = self._prefill(self.params, {"tokens": prompts})
                _sync(self.device)
            t_pf = time.perf_counter() - t0
            # move prefill KV into the fixed-capacity decode cache
            states = steps.decode_state(cfg, B, S + gen, self.device)
            if self.env.active:
                states = steps.place_tree(states, steps.decode_state_shardings(
                    cfg, states, self.env))
            states = _install_prefill(states, pf_states)
            cache_len = S
        generated = [tok]
        t0 = time.perf_counter()
        with record_function("decode"):
            for i in range(gen - 1):
                tok, states = self._decode(self.params, tok, states, cache_len + i)
                generated.append(tok)
            _sync(self.device)
        t_dec = time.perf_counter() - t0
        tokens = torch.cat(generated, dim=1)
        if isinstance(tokens, DTensor):
            tokens = tokens.full_tensor()
        return {"tokens": tokens.cpu(), "prefill_s": t_pf, "decode_s": t_dec}

    # -- serving-tier adapter ---------------------------------------------
    def infer(self, payload=None) -> dict:
        """One inference request, as the workloads serving tier calls it.
        The payload is a dict of knobs: ``prompt_len`` (default 16), ``gen``
        (default 8), ``batch`` (default 1); prompts are synthetic, drawn
        from the engine's generator."""
        p = payload or {}
        B = int(p.get("batch", 1))
        S = int(p.get("prompt_len", 16))
        gen = max(2, int(p.get("gen", 8)))
        out = self.generate(self.synthetic_prompts(B, S), gen)
        return {"arch": self.arch, "tokens": out["tokens"][0].tolist(),
                "batch": B, "prompt_len": S,
                "decode_ms_per_token": out["decode_s"] / max(gen - 1, 1) * 1e3}


def _install_prefill(states, pf_states):
    """Write prefill K/V into the decode cache at positions [0, S), and
    pass recurrent state dicts through from prefill.

    In place for the KV caches: each is allocated once per batch at
    capacity S+gen, and the prompt's K/V are copied into its first S slots.
    A DTensor cache is made anew instead: the prompt's K/V and zeros up to
    capacity, in the cache's placements."""

    def install(slot, new):
        if not isinstance(slot, KVCache):
            return new
        if isinstance(slot.k, DTensor):
            return KVCache(*(_padded(c, n) for c, n in zip(slot, new)))
        s = new.k.shape[-2]
        slot.k[..., :s, :].copy_(new.k)
        slot.v[..., :s, :].copy_(new.v)
        return slot

    if isinstance(states, list):
        return [install(slot, new) for slot, new in zip(states, pf_states)]
    return install(states, pf_states)


def _padded(slot: DTensor, new: DTensor) -> DTensor:
    """``new`` (…, S, D) zero-padded along S to ``slot``'s capacity, in
    ``slot``'s placements."""
    pad = list(slot.shape)
    pad[-2] -= new.shape[-2]
    full = torch.cat([new, torch.zeros(pad, dtype=new.dtype, device=new.device)], dim=-2)
    return full.redistribute(slot.device_mesh, slot.placements)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=8, help="batch size")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="1", help="e.g. 2x2 = data x model")
    ap.add_argument("--ctx-parallel", action="store_true",
                    help="shard the KV cache's sequence over the model axis")
    ap.add_argument("--profile", action="store_true",
                    help="after one warm-up batch, trace one more with "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args(argv)
    if args.profile and args.mesh != "1":
        raise SystemExit("--profile traces one device's generate: run it without --mesh")

    engine = ServeEngine(args.arch, tiny=args.tiny, seed=args.seed,
                         device=args.device, mesh=args.mesh,
                         ctx_parallel=args.ctx_parallel)
    B, S = args.requests, args.prompt_len
    prompts = engine.synthetic_prompts(B, S)
    out = engine.generate(prompts, args.gen)
    toks, t_pf, t_dec = out["tokens"], out["prefill_s"], out["decode_s"]
    if engine.env.active and torch.distributed.get_rank() != 0:
        return  # rank 0 prints

    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else str(engine.device))
    print(f"arch={engine.cfg.name} device={where} requests={B} prompt={S} "
          f"generated={toks.shape[1]}")
    if t_pf:
        print(f"prefill: {B * S / t_pf:,.0f} tok/s ({t_pf*1e3:.1f} ms)")
    print(f"decode:  {B * (args.gen - 1) / max(t_dec, 1e-9):,.0f} tok/s "
          f"({t_dec / max(args.gen - 1, 1) * 1e3:.2f} ms/token)")
    print(f"sample continuation (req 0): {toks[0, :12].tolist()}")
    if args.profile:
        _print_profile(engine, prompts, args.gen)


def _print_profile(engine, prompts, gen):
    """Trace one generate: device time by kernel, and each phase's wall
    time beside the device time spent in it (the rest is the device idle,
    waiting on the host)."""
    cuda = engine.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        engine.generate(prompts, gen)
    sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=25))
    if not cuda:
        return
    events = prof.events()
    for phase in PHASES:
        span = [e for e in events if e.name == phase
                and e.device_type == DeviceType.CPU]
        if not span:
            continue
        lo, hi = span[0].time_range.start, span[0].time_range.end
        busy = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in PHASES
                   and lo <= e.time_range.start and e.time_range.end <= hi)
        wall = hi - lo
        print(f"profile {phase}: wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / max(wall, 1):.1f}%), "
              f"idle {100 * (1 - busy / max(wall, 1)):.1f}%")


if __name__ == "__main__":
    main()
