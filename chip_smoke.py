#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100. Run from the root of a checkout:

    python3 chip_smoke.py

Phases; any failure makes the script exit non-zero:

1. The card: CUDA must be available; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for fp32 products.
2. The build: compiles every kernel source of the port with nvcc, all at
   once, and prints the build time and ptxas's registers, shared memory
   and spills.
3. Kernel against plain: each kernel against its plain PyTorch version on
   the card over a case list (tolerance 2e-5 in fp32, 2e-2 in bf16), then
   CUDA-event times of the kernel, the plain version and the one PyTorch
   call that computes the same function, beside the card's least time
   for the work, at the main path's shape.
4. The slice at full width: ``ServeEngine("smollm-360m", tiny=False)``
   (32 layers, stacked layout, seeded random weights) serves 3 ``infer``
   requests and one ``generate`` of 8 prompts of 512 tokens, 32 new
   tokens each. The kernels' launch counts are set to 0 just before and
   read just after: each prefill must launch the flash kernel once per
   layer. Then prefill's last logits through the kernel are held against
   the same engine with the plain attention (``attn_force="ref"``).
5. One JSON line ``{"kernels": [...]}``, then, as the last line,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package. With no CUDA, or outside
a checkout of the repository, it fails before printing any result.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS, smem_bytes  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.nn import attention, blocks, layers  # noqa: E402
from repro_torch.utils.trees import tree_map_with_path  # noqa: E402

ARCH = "smollm-360m"
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s of HBM3 and
# FLOP/s by operand type (bf16 on tensor cores, fp32 on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Prefill logits through the kernel vs the plain attention, 32 layers deep:
# in bf16 each path rounds its fp32 attention to bf16 on its own, and the
# residual stream carries those one-ulp differences through every layer;
# in fp32 only the order of the sums differs.
LOGITS_TOL = {torch.bfloat16: 0.1, torch.float32: 1e-3}

# (B, H, KV, S, D, causal, window), the cases of tests/test_kernels.py
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, 0),
    (1, 8, 8, 128, 128, True, 0),
    (2, 4, 1, 256, 64, True, 64),
    (1, 2, 2, 128, 64, False, 0),
    (1, 15, 5, 128, 64, True, 0),
    (2, 2, 2, 512, 32, True, 128),
]
EXTRA_CASES = [
    (2, 4, 2, 256, 16, True, 0),       # head_dim 16 (smollm tiny)
    (2, 8, 2, 256, 128, True, 0),      # head_dim 128, GQA
    (1, 4, 2, 200, 64, True, 0),       # ragged length
    (2, 15, 5, 1000, 64, True, 0),     # ragged length, smollm heads
    (1, 4, 1, 1000, 128, True, 256),   # ragged length, local window
]
PREFILL = (8, 15, 5, 512, 64, True, 0)     # smollm-360m prefill, B=8, S=512
PREFILL_LONG = (8, 15, 5, 2048, 64, True, 0)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def qkv(gen, b, h, kv, sq, d, dtype, skv=None):
    skv = sq if skv is None else skv
    return (randn(gen, (b, h, sq, d), dtype), randn(gen, (b, kv, skv, d), dtype),
            randn(gen, (b, kv, skv, d), dtype))


def max_err(out, want):
    """(max |out - want|, whether |out - want| <= tol + tol*|want| holds)."""
    tol = TOL[want.dtype]
    diff = (out.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= tol + tol * want.float().abs()).all())


def time_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, kv, sq, d, causal, window, dtype, skv=None, q_offset=0):
    """Least time on the card: the larger of the bytes (q, k, v read once, o
    written once) over HBM bandwidth and the operations (2 products of 2
    FLOP per unmasked (query, key) pair and head dim) over the peak rate."""
    skv = sq if skv is None else skv
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, int)
    pairs = int(np.clip(hi - lo, 0, None).sum())
    flops = 4 * d * pairs * b * h
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * sq * d + 2 * b * kv * skv * d) * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def phase_build(failures):
    names = [p.stem for p in sorted(_build.CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    _build.build(names)
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name in names:
        for line in _build.log_path(name).read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    if not names:
        failures.append("no kernel sources found")
    print("  flash_attention dynamic shared memory per block: "
          + ", ".join(f"D={d}: {smem_bytes(d)} B" for d in HEAD_DIMS))


def phase_kernels(failures):
    """Every kernel against its plain version; times at the prefill shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0

    def check(label, q, k, v, want, **kw):
        nonlocal worst
        out = ops.flash_attention(q, k, v, force="kernel", **kw)
        torch.cuda.synchronize()
        err, ok = max_err(out, want)
        worst = max(worst, err)
        print(f"case {label}: max_abs_err={err:.3e} tol={TOL[q.dtype]:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention {label}: max_abs_err {err:.3e}")
        return err

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for b, h, kv, s, d, causal, window in FLASH_CASES + EXTRA_CASES:
            q, k, v = qkv(gen, b, h, kv, s, d, dtype)
            check(f"B{b} H{h} KV{kv} S{s} D{d} causal={causal} window={window} {dt}",
                  q, k, v, ref.flash_attention_ref(q, k, v, causal=causal, window=window),
                  causal=causal, window=window)
        # q as a suffix of the kv sequence (tests/test_kernels.py:60)
        q, k, v = qkv(gen, 1, 4, 4, 256, 64, dtype)
        full = ref.flash_attention_ref(q, k, v, causal=True)
        check(f"q_offset suffix S256 last64 {dt}", q[:, :, -64:].contiguous(), k, v,
              full[:, :, -64:], causal=True, q_offset=192)
        # ragged Sq != Skv with an offset and a window
        q, k, v = qkv(gen, 2, 6, 2, 100, 64, dtype, skv=300)
        check(f"Sq100 Skv300 q_offset=200 window=96 {dt}", q, k, v,
              ref.flash_attention_ref(q, k, v, causal=True, window=96, q_offset=200),
              causal=True, window=96, q_offset=200)

    timings = {}
    for label, shape in (("prefill", PREFILL), ("prefill_long", PREFILL_LONG)):
        b, h, kv, s, d, causal, window = shape
        q, k, v = qkv(gen, b, h, kv, s, d, torch.bfloat16)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        err = check(f"{label} B{b} H{h} KV{kv} S{s} D{d} bfloat16", q, k, v, want,
                    causal=True)
        row = {"max_abs_err": err,
               "ms": time_ms(lambda: ops.flash_attention(q, k, v, force="kernel")),
               "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=10),
               "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True)),
               **attention_bound(b, h, kv, s, d, causal, window, torch.bfloat16)}
        print(f"{label} B{b} H{h} KV{kv} S{s} D{d} bf16: kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['flops'] / 1e9:.2f} GFLOP, {row['bytes'] / 1e6:.2f} MB)")
        timings[label] = row
    print(f"flash_attention: worst max_abs_err over all cases {worst:.3e}")
    return timings, worst


def phase_slice(failures):
    """The serving main path at full width, with launch counts."""
    t0 = time.perf_counter()
    engine = ServeEngine(ARCH, tiny=False, seed=0, device="cuda")
    cfg = engine.cfg
    torch.cuda.synchronize()
    print(f"engine: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"stacked={cfg.scan_layers} params={cfg.param_count():,} "
          f"built in {time.perf_counter() - t0:.1f} s")
    payloads = [{"prompt_len": 128, "gen": 8, "batch": 2},
                {"prompt_len": 64, "gen": 4}, {}]
    B, S, GEN = 8, 512, 32
    prompts = engine.synthetic_prompts(B, S)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    answers = [engine.infer(p) for p in payloads]
    out = engine.generate(prompts, GEN)
    launches = ops.launch_counts()

    n_prefills = len(payloads) + 1
    want = cfg.n_layers * n_prefills
    print(f"launches on the main path: {launches} ({n_prefills} prefills x "
          f"{cfg.n_layers} layers = {want} expected for flash_attention)")
    if launches["flash_attention"] != want:
        failures.append(f"flash_attention launched {launches['flash_attention']} "
                        f"times, want {want}")
    for p, a in zip(payloads, answers):
        n = max(2, int(p.get("gen", 8)))
        if len(a["tokens"]) != n or not all(0 <= t < cfg.vocab_size for t in a["tokens"]):
            failures.append(f"infer {p}: bad tokens {a['tokens']}")
    toks = out["tokens"]
    if tuple(toks.shape) != (B, GEN) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        failures.append(f"generate: tokens of shape {tuple(toks.shape)} out of range")
    peak = torch.cuda.max_memory_allocated()
    metrics = {"prefill_tok_s": B * S / out["prefill_s"],
               "prefill_ms": out["prefill_s"] * 1e3,
               "decode_ms_per_token": out["decode_s"] / (GEN - 1) * 1e3,
               "decode_tok_s": B * (GEN - 1) / out["decode_s"],
               "peak_mem_gib": peak / 2**30}
    print(f"generate B={B} prompt={S} gen={GEN}: prefill {metrics['prefill_tok_s']:,.0f} tok/s "
          f"({metrics['prefill_ms']:.2f} ms), decode {metrics['decode_ms_per_token']:.3f} "
          f"ms/token ({metrics['decode_tok_s']:,.0f} tok/s), peak memory "
          f"{metrics['peak_mem_gib']:.2f} GiB; sample {toks[0, :8].tolist()}")

    metrics.update(check_attention_per_layer(engine, prompts.cuda(), failures))
    metrics.update(check_logits(cfg, engine.params, prompts.cuda(), failures))
    return launches, metrics


def check_attention_per_layer(engine, tokens, failures):
    """Each layer's attention through the kernel against the plain version,
    on that layer's own q/k/v in the engine's bf16 model (the hidden state
    is carried along the plain path, so every layer sees real inputs)."""
    cfg, p = engine.cfg, engine.params
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    worst, bad = 0.0, []
    with torch.inference_mode():
        x = layers.embed_lookup(p["embed"], tokens).to(torch.bfloat16)
        for i in range(cfg.n_layers):
            lp = tree_map_with_path(lambda _, t: t[i], p["blocks"]["scan"])
            h = layers.rmsnorm(lp["norm1"], x)
            q, k, v = attention._project_qkv(lp["attn"], h, positions, cfg.rope_theta)
            err, ok = max_err(ops.flash_attention(q, k, v, force="kernel"),
                              ops.flash_attention(q, k, v, force="ref"))
            worst = max(worst, err)
            if not ok:
                bad.append(i)
            x, _ = blocks.apply_attn_block(lp, x, cfg, positions=positions,
                                           attn_force="ref")
    print(f"attention per layer, kernel vs plain on each layer's own q/k/v "
          f"({cfg.n_layers} layers, bf16, tol {TOL[torch.bfloat16]}): worst "
          f"max_abs_err={worst:.3e}, layers out of tolerance {bad}")
    if bad:
        failures.append(f"attention disagrees with the plain version at layers {bad}")
    return {"attn_per_layer_max_abs_err": worst}


def true_fan_in(params, cfg):
    """The seeded weights with the attention projections rescaled to their
    true fan-in (d_model into q/k/v, heads x head_dim into the output). The
    reference init divides by the size of the heads axis instead
    (repro/nn/params.py ``_fan_in``), so q and k come out with std 8 and 14,
    attention is nearly one-hot, and the random network is chaotic at
    depth: two correct attention paths that round differently end in
    unrelated logits (the default-init line of ``check_logits`` shows it)."""
    d, hd = cfg.d_model, cfg.hd
    rescale = {"blocks/scan/attn/wq": math.sqrt(cfg.n_heads / d),
               "blocks/scan/attn/wk": math.sqrt(cfg.n_kv_heads / d),
               "blocks/scan/attn/wv": math.sqrt(cfg.n_kv_heads / d),
               "blocks/scan/attn/wo": math.sqrt(hd / (cfg.n_heads * hd))}
    return tree_map_with_path(
        lambda path, t: t * rescale[path] if path in rescale else t, params)


def last_logits(cfg, params, tokens, attn_force):
    with torch.inference_mode():
        _, _, last = steps.make_prefill_step(cfg, attn_force=attn_force)(
            params, {"tokens": tokens})
    return last


def check_logits(cfg, params, tokens, failures):
    """Prefill's last logits through the kernel against the plain attention,
    at full width. Asserted on the true-fan-in weights, in bf16 and in fp32;
    reported only for the default init."""
    fan_in = true_fan_in(params, cfg)
    runs = (("default init, bf16", cfg, params, None),
            ("true fan-in, bf16", cfg, fan_in, LOGITS_TOL[torch.bfloat16]),
            ("true fan-in, fp32", cfg.replace(dtype="float32"),
             tree_map_with_path(lambda _, t: t.float(), fan_in),
             LOGITS_TOL[torch.float32]))
    out = {}
    for label, run_cfg, run_params, tol in runs:
        last = last_logits(run_cfg, run_params, tokens, None)
        want = last_logits(run_cfg, run_params, tokens, "ref")
        torch.cuda.synchronize()
        err = (last - want).abs().max().item()
        same = last.argmax(-1) == want.argmax(-1)
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        print(f"prefill last logits, kernel vs plain attention ({label}): "
              f"max_abs_err={err:.3e} tol={tol} argmax equal on {int(same.sum())}/"
              f"{len(want)} rows (plain top-1 margins "
              f"{[round(m, 4) for m in margin.tolist()]}) "
              f"finite={bool(torch.isfinite(last).all())}")
        out[f"logits_max_abs_err ({label})"] = err
        if tol is None:
            continue
        # Where the plain top-1 margin exceeds 2 tol, logits within tol
        # cannot change the argmax; closer races are reported above.
        decided = margin > 2 * tol
        if not (err <= tol and bool(same[decided].all())
                and bool(torch.isfinite(last).all())
                and tuple(last.shape) == (tokens.shape[0], cfg.vocab_size)):
            failures.append(f"prefill logits ({label}): err {err:.3e} (tol {tol}), "
                            f"argmax differs on {int((~same & decided).sum())} "
                            f"decided rows")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on a "
              "CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    failures = []
    phase_build(failures)
    timings, worst = phase_kernels(failures)
    launches, metrics = phase_slice(failures)

    pf = timings["prefill"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "launches": launches["flash_attention"],
        "max_abs_err": pf["max_abs_err"],
        "max_err": pf["max_abs_err"],
        "worst_case_max_abs_err": worst,
        "ms": pf["ms"],
        "kernel_ms": pf["ms"],
        "plain_ms": pf["plain_ms"],
        "bound_ms": pf["bound_ms"],
        "bound_by": pf["bound_by"],
        "library_ms": pf["library_ms"],
        "shape": "B8 H15 KV5 S512 D64 bf16 causal",
        "long": {k: timings["prefill_long"][k]
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    }]
    print(f"card: {card}; slice: {json.dumps(metrics)}; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
