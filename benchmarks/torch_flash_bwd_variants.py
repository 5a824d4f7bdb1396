#!/usr/bin/env python3
"""Tile-shape variants of the port's bf16 flash-attention backward
(``src/repro_torch/csrc/flash_attention_bwd_sm90.cu``) on one NVIDIA H100.
Run from the root of a checkout:

    python3 benchmarks/torch_flash_bwd_variants.py

Each variant is the source with some of its tile constants changed: a
3-stage ring (``st3``), 128-key tiles streamed through the dQ kernel
(``qbn128``), 128-query tiles streamed through the dK/dV kernel
(``kvbn128``, at D <= 64), and their pairs; ``base`` is the source as it
ships. All are built at once by nvcc into ``build/kernels/variants/``,
launched through the port's wrapper at the train path's shapes (smollm, B8
H15 KV5 S512 and S2048, D64, bf16, causal) and timed as ``chip_smoke.py``
times the backward (device time over a replayed CUDA graph), twice: in the
list's order, then in reverse. Prints the card, each variant's ptxas spills
and serialized-wgmma advisories, whether its gradients equal ``base``'s bit
for bit, and its two times. Exits non-zero without a card or on a failed
build.
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

SOURCE = "flash_attention_bwd_sm90"
STAGES3 = ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")
QBN128 = ("static constexpr int Q_BN = 64;", "static constexpr int Q_BN = 128;")
KVBN128 = ("static constexpr int KV_BN = D <= 64 ? 64 : 32;",
           "static constexpr int KV_BN = D <= 64 ? 128 : 32;")
VARIANTS = {"base": (), "st3": (STAGES3,), "qbn128": (QBN128,),
            "st3_qbn128": (STAGES3, QBN128), "kvbn128": (KVBN128,),
            "kvbn128_qbn128": (KVBN128, QBN128)}


def build_variants() -> dict[str, tuple[Path, list[str]]]:
    """{variant: (library, ptxas lines reporting a spill or serialized
    wgmma)}; raises with nvcc's output if a build fails."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / f"{SOURCE}.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source once")
            src = src.replace(old, new)
        path = out_dir / f"{name}.cu"
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


def entry_point(lib: Path):
    """The variant's C entry point, typed as the wrapper types the shipped one."""
    fn = getattr(ctypes.CDLL(str(lib)), SOURCE)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_bwd_variants: torch.cuda.is_available() is false; this runs on "
              "a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}")
    built = build_variants()
    for name, (_, problems) in built.items():
        print(f"{name}: ptxas spills / serialized wgmma: {problems or 'none'}")
    fns = {name: entry_point(lib) for name, (lib, _) in built.items()}
    shipped = fa._bwd
    gen = torch.Generator(device="cuda").manual_seed(2)
    try:
        for label, (b, h, kv, s, d) in chip_smoke.BWD_MAIN.items():
            q, k, v, do = chip_smoke.grad_inputs(gen, b, h, kv, s, s, d, torch.bfloat16)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, causal=True)
            grads, times = {}, {name: [] for name in fns}
            for name, fn in fns.items():
                fa._bwd = lambda dtype, fn=fn: fn
                grads[name] = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
            iters = 10 if s > 1024 else 50
            for order in (list(fns), list(reversed(fns))):
                for name in order:
                    fa._bwd = lambda dtype, fn=fns[name]: fn
                    times[name].append(chip_smoke.device_ms(
                        lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse), iters=iters))
            for name in fns:
                same = all(torch.equal(a, g) for a, g in zip(grads[name], grads["base"]))
                print(f"{label} {name}: dq/dk/dv {'equal' if same else 'NOT equal'} to base "
                      f"bit for bit; device ms (in order, reversed) "
                      f"{times[name][0]:.4f}, {times[name][1]:.4f}")
    finally:
        fa._bwd = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
