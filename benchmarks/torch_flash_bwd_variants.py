#!/usr/bin/env python3
"""Variants of the port's flash-attention backward on one NVIDIA
H100, either route. Run from the root of a checkout:

    python3 benchmarks/torch_flash_bwd_variants.py [bf16|fp32] [VARIANT ...]

Each variant is a route's source with some of its constants or lines
changed; ``base`` is the source as it ships. bf16 (the default,
``src/repro_torch/csrc/flash_attention_bwd_sm90.cu``, whose dK/dV kernel
computes dQ too at FUSED_DQ_HEAD_DIMS, 16 to 64): ``split3``, no head dim
fused (the Δ, dK/dV and dQ kernels of the split route, the design before
the fusion); a 3-stage ring (``st3``, fused, and ``split3_st3``); on the
split route at D <= 64, 128-key tiles streamed through the dQ kernel
(``split3_qbn128``) and 128-query tiles streamed through the dK/dV kernel
(``split3_kvbn128``, which the fused route's 64 x 64 tiles rule out); the
fused route with its dQ sum in ascending key-tile order at every launch
size, the grid's order before the fusion (``ascending``), and in groups of
a wave's key tiles at every size (``grouped``: base's library,
``flash_attention.dq_group`` replaced), and in groups of 2 or 3 past two
waves (``group2``, ``group3``); each dQ part written to shared
memory while the next step's S and dP run instead of after its own step's
products (``dqearly``); and two of the fused route with a part of its dQ
sum taken out, to read what the sum costs, whose dQ is wrong: ``noorder``
adds without waiting its turn, ``noadd`` adds
nothing. fp32 (``src/repro_torch/csrc/flash_attention_bwd.cu``):
two D tiles folded at once, not four (``fold2``), three blocks a SM up to
D = 64 (``mb3``, which caps ptxas at 168 registers), 16-row streamed tiles
at every head dim (``bs16``), their pairs, and the score products' K-major
fragments by 4-byte loads instead of ``ldmatrix`` (``lds32``), and dV, dK
and dQ summed in their long-running mma accumulators instead of a fresh
accumulator a tile (``longacc``), and at D = 256 both warps of a slab
computing both score tiles instead of one each, swapped through shared
memory (``redundant``). On both routes ``nosplit`` is ``base`` with the
dK/dV walk unsplit at every shape (P = 1, one dK/dV block a key tile: the
grid before the split), where ``base`` runs the planner's P
(``flash_attention.bwd_plan``, printed), and ``p2``, ``p3`` and ``p6`` are
``base`` at that P forced (skipped where a walk is shorter). Named variants
after the route run those alone, beside ``base``. All are
built at once by nvcc into ``build/kernels/variants/``, launched through the
port's wrapper at the route's timed shapes (``chip_smoke.BWD_MAIN`` for
bf16, ``chip_smoke.BWD_FP32`` for fp32: smollm's D64 and recurrentgemma's
D256, causal) and timed as
``chip_smoke.py`` times the backward (device time over a replayed CUDA
graph), twice: in the list's order, then in reverse. Prints the card, each
variant's ptxas spills and serialized-wgmma advisories, whether its
gradients equal ``base``'s bit for bit, their largest error against the
plain backward over the largest magnitude of each gradient, and its two
times; then each variant's error so measured on every case of
``chip_smoke.BWD_CASES`` and ``BWD_CASES_D256`` in the route's dtype.
Exits non-zero without a card or on a failed build.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

STAGES3 = ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")
UNFUSED = ("constexpr int FUSED_DQ_HEAD_DIMS = 16 | 32 | 64;", "constexpr int FUSED_DQ_HEAD_DIMS = 0;")
NOORDER = ("          wait_turn(ctr, turn);\n", "")
ASCENDING = ("C::FUSED ? group : 1,", "1,")
# each dQ part written to shared memory while the next step's S and dP run,
# not after its own step's products
DQ_EARLY = (("      issue_ss<D, BN>(dp, s_v, BM, do_st);  // dPᵀ = V dOᵀ\n      wgmma_commit();\n",
             "      issue_ss<D, BN>(dp, s_v, BM, do_st);  // dPᵀ = V dOᵀ\n      wgmma_commit();\n"
             "      if constexpr (C::FUSED) {\n        if (step > 0) put_dq(step - 1);\n      }\n"),
            ("        put_dq(step);\n      }\n    }\n",
             "      }\n    }\n    if constexpr (C::FUSED) {\n      if (n_steps > 0) put_dq(n_steps - 1);\n"
             "    }\n"))
NOADD = ("            tma_store_or_add(&tm_dqw,", "            if (false) tma_store_or_add(&tm_dqw,")
QBN128 = ("static constexpr int Q_BN = D <= 128 ? 64 : 32;",
          "static constexpr int Q_BN = D <= 64 ? 128 : D <= 128 ? 64 : 32;")
KVBN128 = ("static constexpr int KV_BN = D <= 64 ? 64 : 32;",
           "static constexpr int KV_BN = D <= 64 ? 128 : 32;")
FOLD2 = ("static constexpr int FOLD = 4 < DT ? 4 : DT;",
         "static constexpr int FOLD = 2 < DT ? 2 : DT;")
MB3 = ("static constexpr int MIN_BLOCKS = D == 16 ? 3 : SPLIT == 1 ? 2 : 1;",
       "static constexpr int MIN_BLOCKS = D <= 64 ? 3 : SPLIT == 1 ? 2 : 1;")
BS16 = ("static constexpr int BS = D <= 64 ? 32 : 16;", "static constexpr int BS = 16;")
# the score products' K-major fragments by 4-byte loads, as before ldmatrix
LDS32_ADDR = ("""  const float* ar = a + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
  const float* br = b + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;""",
              """  const float* ar = a + (lane >> 2) * LD + (lane & 3);
  const float* br = b + (lane >> 2) * LD + (lane & 3);""")
LDS32_LOADS = ("""    uint32_t ah[4], al[4], bh[NS][2], bl[NS][2], r[4];
    ldsm_x4(r, ar + 8 * kk);
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      ldsm_x4(r, br + 8 * n * LD + 8 * kk);
      split(__uint_as_float(r[0]), bh[n][0], bl[n][0]);
      split(__uint_as_float(r[1]), bh[n][1], bl[n][1]);
      split(__uint_as_float(r[2]), bh[n + 1][0], bl[n + 1][0]);
      split(__uint_as_float(r[3]), bh[n + 1][1], bl[n + 1][1]);
    }""", """    uint32_t ah[4], al[4], bh[NS][2], bl[NS][2];
    split(ar[8 * kk], ah[0], al[0]);
    split(ar[8 * LD + 8 * kk], ah[1], al[1]);
    split(ar[8 * kk + 4], ah[2], al[2]);
    split(ar[8 * LD + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      split(br[8 * n * LD + 8 * kk], bh[n][0], bl[n][0]);
      split(br[8 * n * LD + 8 * kk + 4], bh[n][1], bl[n][1]);
    }""")
# dV, dK and dQ summed in the long-running mma accumulators themselves, not
# in a fresh one a tile (the tensor cores round each accumulation toward zero)
LONGACC = ("""      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;""",
           """      for (int e = 0; e < 4; ++e) part[n][e] = sum[n0 + n][e];""")
LONGACC_FOLD = ("""      for (int e = 0; e < 4; ++e) sum[n0 + n][e] += part[n][e];""",
                """      for (int e = 0; e < 4; ++e) sum[n0 + n][e] = part[n][e];""")
# at D = 256 each warp of a slab computes both score tiles itself (the
# SPLIT == 1 path), in both tile kernels
REDUNDANT_KV = ("""    if constexpr (C::SPLIT == 1) {
      scores<D, NS>(st, kw, qs);""", """    if constexpr (true) {
      scores<D, NS>(st, kw, qs);""")
REDUNDANT_Q = ("""    if constexpr (C::SPLIT == 1) {
      scores<D, NS>(s, qw, kst);""", """    if constexpr (true) {
      scores<D, NS>(s, qw, kst);""")
# variants launched with the dK/dV walk's split forced (P = 1: unsplit)
FORCED = {"nosplit": 1, "p2": 2, "p3": 3, "p6": 6}
# bf16 variants that launch base's library with the fused route's dQ order
# planned otherwise: groups of a wave's key tiles at every launch size
# (``grouped``; base groups them only within DQ_GROUP_WAVES waves), and
# groups of 2 or 3 key tiles past that
ORDERS = {"grouped": lambda b, kv, split, k_tiles, slots: max(1, slots // (b * kv * split)),
          **{f"group{g}": (lambda g: lambda b, kv, split, k_tiles, slots: (
              g if b * kv * split * k_tiles > fa.DQ_GROUP_WAVES * slots
              else max(1, slots // (b * kv * split))))(g) for g in (2, 3)}}
PLANNER_ONLY = {**FORCED, **ORDERS}
# route -> (dtype, source, {variant: edits}, {label: (B, H, KV, S, D, causal)} timed)
ROUTES = {
    "bf16": (torch.bfloat16, "flash_attention_bwd_sm90",
             {"base": (), **dict.fromkeys(FORCED, ()), **dict.fromkeys(ORDERS, ()),
              "split3": (UNFUSED,), "st3": (STAGES3,),
              "split3_st3": (UNFUSED, STAGES3), "split3_qbn128": (UNFUSED, QBN128),
              "split3_kvbn128": (UNFUSED, KVBN128), "ascending": (ASCENDING,), "dqearly": DQ_EARLY,

              "noorder": (NOORDER,),
              "noadd": (NOADD,)},
             chip_smoke.BWD_MAIN),
    "fp32": (torch.float32, "flash_attention_bwd",
             {"base": (), **dict.fromkeys(FORCED, ()), "fold2": (FOLD2,), "mb3": (MB3,),
              "fold2_mb3": (FOLD2, MB3),
              "bs16": (BS16,), "bs16_mb3": (BS16, MB3), "lds32": (LDS32_ADDR, LDS32_LOADS),
              "longacc": (LONGACC, LONGACC_FOLD), "redundant": (REDUNDANT_KV, REDUNDANT_Q)},
             {label: chip_smoke.BWD_MAIN[label] for label in chip_smoke.BWD_FP32}),
}


def variant_source(text: str, edits) -> str:
    """The source with each (old, new) edit made; raises unless each old
    text is in it once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in the source once")
        text = text.replace(old, new)
    return text


def build_variants(source, variants) -> dict[str, tuple[Path, list[str]]]:
    """{variant: (library, ptxas lines reporting a spill or serialized
    wgmma)}; raises with nvcc's output if a build fails."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        src = variant_source(text, edits)
        path = out_dir / f"{source}_{name}.cu"
        path.write_text(src)
        lib = path.with_suffix(".so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{log}")
        problems = [line.strip() for line in log.splitlines()
                    if "serialized" in line
                    or any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
        built[name] = (lib, problems)
    return built


def entry_point(lib: Path, source: str, dtype):
    """The variant's C entry point, typed as the wrapper types the shipped one."""
    fn = getattr(ctypes.CDLL(str(lib)), source)
    fn.argtypes = fa.bwd_argtypes(dtype)
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    route = argv[0] if argv else "bf16"
    if route not in ROUTES:
        print(f"torch_flash_bwd_variants: route {route!r} not in {list(ROUTES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_flash_bwd_variants: torch.cuda.is_available() is false; this runs on "
              "a CUDA card", file=sys.stderr)
        return 1
    dtype, source, variants, shapes = ROUTES[route]
    if argv[1:]:
        variants = {name: variants[name] for name in ("base", *argv[1:])}
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()}; route {route}: {source}.cu")
    # the forced splits launch base's library
    built = build_variants(source, {n: e for n, e in variants.items() if n not in PLANNER_ONLY})
    for name, (_, problems) in built.items():
        print(f"{name}: ptxas spills / serialized wgmma: {problems or 'none'}")
    fns = {name: entry_point(built[name if name in built else "base"][0], source, dtype)
           for name in variants}
    shipped, shipped_group = fa._bwd, fa.dq_group
    gen = torch.Generator(device="cuda").manual_seed(2)
    try:
        for label, (b, h, kv, s, d, causal) in shapes.items():
            q, k, v, do = chip_smoke.grad_inputs(gen, b, h, kv, s, s, d, dtype)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, causal=causal)
            want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
            grads, times = {}, {name: [] for name in fns}
            split = {name: FORCED.get(name) for name in fns}
            for name, fn in fns.items():
                fa._bwd = lambda dtype, fn=fn: fn
                fa.dq_group = ORDERS.get(name, shipped_group)
                try:
                    grads[name] = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                                              split=split[name])
                except ValueError as e:  # a forced P past this shape's walks
                    print(f"{label} {name}: skipped ({e})")
            iters = 10 if s > 1024 or dtype == torch.float32 else 50
            for order in (list(grads), list(reversed(grads))):
                for name in order:
                    fa._bwd = lambda dtype, fn=fns[name]: fn
                    fa.dq_group = ORDERS.get(name, shipped_group)
                    times[name].append(chip_smoke.device_ms(
                        lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                                            split=split[name]),
                        iters=iters))
            print(f"{label}: planned P={fa.bwd_plan(q, k, causal=causal)}")
            for name in grads:
                same = all(torch.equal(a, g) for a, g in zip(grads[name], grads["base"]))
                rel = max((g.float() - w.float()).abs().max().item()
                          / w.float().abs().max().item() for g, w in zip(grads[name], want))
                print(f"{label} {name}: dq/dk/dv {'equal' if same else 'NOT equal'} to base "
                      f"bit for bit, max_abs_err/max|grad| against plain {rel:.2e}; device ms "
                      f"(in order, reversed) {times[name][0]:.4f}, {times[name][1]:.4f}")
        cases = []  # the same inputs for every variant
        for b, h, kv, sq, skv, d, causal, window, q_offset in (chip_smoke.BWD_CASES
                                                               + chip_smoke.BWD_CASES_D256):
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            q, k, v, do = chip_smoke.grad_inputs(gen, b, h, kv, sq, skv, d, dtype)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            cases.append(((q, k, v, o, do, lse), kw,
                          ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)))
        for name, fn in fns.items():
            fa._bwd = lambda dtype, fn=fn: fn
            fa.dq_group = ORDERS.get(name, shipped_group)
            rels = []
            for args, kw, want in cases:
                try:
                    got = fa.flash_attention_bwd_cuda(*args, split=FORCED.get(name), **kw)
                except ValueError:  # a forced P past this case's walks
                    rels.append("n/a")
                    continue
                rel = max((g.float() - w.float()).abs().max().item()
                          / w.float().abs().max().item() for g, w in zip(got, want))
                rels.append(f"{rel:.2e}")
            print(f"{name}: max_abs_err/max|grad| against plain on chip_smoke.BWD_CASES + "
                  f"BWD_CASES_D256 {', '.join(rels)}")
    finally:
        fa._bwd, fa.dq_group = shipped, shipped_group
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
