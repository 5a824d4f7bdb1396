#!/usr/bin/env python3
"""Schedule variants of the port's bf16 flash forward
(``src/repro_torch/csrc/flash_attention_sm90.cu``) on one NVIDIA H100. Run
from the root of a checkout:

    python3 benchmarks/torch_flash_fwd_variants.py [VARIANT ...]

Each variant is the source with one or more choices of its schedule
changed; ``base`` is the source as it ships: one consumer warpgroup a block
and two blocks a SM up to head_dim 64, two consumers a block above; the
pipeline inside a consumer and the ping-pong of two at head_dim 128; a
persistent grid at every head dim, and two Q buffers up to head_dim 128:

- ``nopipe``: no pipeline: each consumer warpgroup issues S, waits for it,
  runs the softmax, then issues P.V and waits for it; ``pipe``: the
  pipeline (S of tile r in flight beside P.V of tile r - 1, the softmax
  beside P.V) at every head dim;
- ``nopingpong``: no named barriers: a block's two consumers issue their
  products when they will; ``pingpong256``: the ping-pong at head_dim 256
  too;
- ``consumers2``: a block of two consumers, one block a SM, up to head_dim
  64 too, with the pipeline and the ping-pong there; ``consumers2_nopipe``:
  the same with the ping-pong alone there;
- ``nopersist``: a block a work tile (the grid of tiles);
- ``q1``: one Q buffer at every head dim;
- ``serial``: ``nopipe``, ``nopingpong``, ``nopersist`` and ``q1``
  together, the schedule from before the redesign.

None of them moves a rounding, so each must equal ``base`` bit for bit.
Named variants run alone beside ``base``. All are built at once by nvcc
into ``build/kernels/variants/`` and launched through the port's wrapper.
Prints the card; each variant's ptxas registers a thread, spills and
serialized-wgmma advisories; whether its O and lse equal ``base``'s bit for
bit on every bf16 forward case of ``chip_smoke.py``
(``chip_smoke.fwd_bf16_cases``); and its device time at each
``chip_smoke.FLASH_MAIN`` shape (``chip_smoke.device_ms``: a replayed CUDA
graph), twice: in the list's order, then in reverse. Exits non-zero without
a card, on a failed build, on a spill or serialized wgmma in ``base`` or on
a differing bit.
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

SOURCE = "flash_attention_sm90"
ALL = "16 | 32 | 64 | 128 | 256"
PIPELINE = "constexpr int PIPELINE_HEAD_DIMS = 128;"
PINGPONG = "constexpr int PINGPONG_HEAD_DIMS = 128;"
CONSUMERS = "static constexpr int CONSUMERS = D <= 64 ? 1 : 2;"
Q_STAGES = "static constexpr int Q_STAGES = D >= 256 ? 1 : 2;"


def at(line: str, mask: str) -> tuple[str, str]:
    """The edit that sets the head-dim mask of ``line`` to ``mask``."""
    return line, line.split(" = ")[0] + f" = {mask};"


NOPIPE, NOPINGPONG = at(PIPELINE, "0"), at(PINGPONG, "0")
NOPERSIST = ("constexpr bool PERSIST = true;", "constexpr bool PERSIST = false;")
Q1 = (Q_STAGES, "static constexpr int Q_STAGES = 1;")
VARIANTS = {"base": (), "nopipe": (NOPIPE,), "pipe": (at(PIPELINE, ALL),),
            "nopingpong": (NOPINGPONG,), "pingpong256": (at(PINGPONG, "128 | 256"),),
            # two consumers a block up to head_dim 64 too, with the pipeline and
            # the ping-pong that made such blocks fastest there
            "consumers2": ((CONSUMERS, "static constexpr int CONSUMERS = 2;"),
                           at(PIPELINE, "16 | 32 | 64 | 128"),
                           at(PINGPONG, "16 | 32 | 64 | 128")),
            "consumers2_nopipe": ((CONSUMERS, "static constexpr int CONSUMERS = 2;"),
                                  at(PINGPONG, "16 | 32 | 64 | 128")),
            "nopersist": (NOPERSIST,), "q1": (Q1,),
            "serial": (NOPIPE, NOPINGPONG, NOPERSIST, Q1)}


def variant_source(text: str, edits) -> str:
    """The source with each (old, new) edit made; raises unless each old
    line is in it once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {SOURCE}.cu once")
        text = text.replace(old, new)
    return text


def ptxas_summary(log: str) -> tuple[dict[int, str], list[str]]:
    """({head dim: registers, stack and spills of its kernel}, the lines
    reporting a spill or serialized wgmma) from nvcc's -Xptxas -v log."""
    kernels, problems, d = {}, [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*flash_fwd_sm90_kernelILi(\d+)E", line)
        if entry:
            d = int(entry.group(1))
        elif d is not None and "bytes stack frame" in line:
            kernels[d] = line.strip()
        elif d is not None and "Used" in line and "registers" in line:
            kernels[d] = f"{line.split('Used')[1].split(',')[0].strip()}; {kernels.get(d, '')}"
            d = None
        if "serialized" in line or any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
            problems.append(line.strip())
    return kernels, problems


def build_variants(variants) -> dict[str, tuple[Path, str]]:
    """{variant: (library, nvcc's log)}; raises with the log if a build fails."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / f"{SOURCE}.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        path = out_dir / f"{SOURCE}_{name}.cu"
        path.write_text(variant_source(text, edits))
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
        built[name] = (lib, log)
    return built


def entry_point(lib: Path):
    """The variant's C entry point, typed as the wrapper types the shipped one."""
    fn = getattr(ctypes.CDLL(str(lib)), f"{SOURCE}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    unknown = [name for name in argv if name not in VARIANTS]
    if unknown:
        print(f"torch_flash_fwd_variants: {unknown} not in {list(VARIANTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_flash_fwd_variants: torch.cuda.is_available() is false; this runs on "
              "a CUDA card", file=sys.stderr)
        return 1
    variants = {name: VARIANTS[name] for name in ("base", *argv)} if argv else VARIANTS
    print(f"card: {chip_smoke.card_line()}; {SOURCE}.cu")
    built = build_variants(variants)
    failed = []
    for name, (_, log) in built.items():
        kernels, problems = ptxas_summary(log)
        print(f"{name}: ptxas " + "; ".join(f"D={d}: {kernels[d]}" for d in sorted(kernels))
              + f"; spills / serialized wgmma: {problems or 'none'}")
        if problems and name == "base":
            failed.append(f"{name}: {problems}")
    fns = {name: entry_point(lib) for name, (lib, _) in built.items()}
    shipped = fa._fwd
    gen = torch.Generator(device="cuda").manual_seed(5)
    try:
        for label, (b, h, kv, sq, skv, d), kw in chip_smoke.fwd_bf16_cases():
            q, k, v = chip_smoke.qkv(gen, b, h, kv, sq, d, torch.bfloat16, skv=skv)
            outs = {}
            for name, fn in fns.items():
                fa._fwd = lambda dtype, fn=fn: fn
                outs[name] = (fa.flash_attention_cuda(q, k, v, **kw),
                              *fa.flash_attention_cuda(q, k, v, return_lse=True, **kw))
            torch.cuda.synchronize()
            differ = [name for name, out in outs.items()
                      if not all(torch.equal(x, y) for x, y in zip(out, outs["base"]))]
            print(f"bits {label} D{d}: O, O with lse and lse of every variant "
                  + (f"equal to base's" if not differ else f"NOT equal to base's in {differ}"))
            if differ:
                failed.append(f"{label}: {differ} differ from base")
            if label not in chip_smoke.FLASH_MAIN:
                continue
            times = {name: [] for name in fns}
            for order in (list(fns), list(reversed(fns))):
                for name in order:
                    fa._fwd = lambda dtype, fn=fns[name]: fn
                    times[name].append(chip_smoke.device_ms(
                        lambda: fa.flash_attention_cuda(q, k, v, **kw)))
            print(f"time {label}: device ms (in order, reversed) " + "; ".join(
                f"{name} {t[0]:.4f}, {t[1]:.4f}" for name, t in times.items()))
    finally:
        fa._fwd = shipped
    print(f"{len(failed)} failures" + (f": {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
