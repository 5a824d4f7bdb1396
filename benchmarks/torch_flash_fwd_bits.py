#!/usr/bin/env python3
"""The port's fp32 flash forward (``src/repro_torch/csrc/flash_attention.cu``)
against another copy of the same source, bit for bit, on one NVIDIA H100.
Run from the root of a checkout, with the other copy's ``csrc`` directory
(for example an earlier commit's, unpacked by ``git archive`` into a
directory that git ignores):

    python3 benchmarks/torch_flash_fwd_bits.py OTHER_CSRC_DIR

Builds ``OTHER_CSRC_DIR/flash_attention.cu`` with the port's nvcc flags
into ``build/kernels/other/``, then runs both libraries through the port's
wrapper on the same fp32 inputs: every flash case of ``chip_smoke.py``
(``FLASH_CASES``, ``EXTRA_CASES`` and the main shapes), with and without
the rows' logsumexp, and prefill's last logits of smollm-360m and
recurrentgemma-2b at full width in fp32 (seeded weights at their true
fan-in, ``chip_smoke.true_fan_in``; B8 S512 prompts). Prints the card and,
for each, whether the two agree bit for bit (``torch.equal``); exits
non-zero where they do not, without a card, or on a failed build.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.utils.trees import tree_map_with_path  # noqa: E402

SOURCE = "flash_attention"


def build_other(csrc: Path):
    """The other copy's forward entry point, typed as the wrapper types the
    checkout's; raises with nvcc's output if the build fails."""
    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{SOURCE}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
           str(csrc / f"{SOURCE}.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc exit {done.returncode}\n{done.stdout}{done.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), f"{SOURCE}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def both(fns, run):
    """``run()`` through each forward library: {name: its output}."""
    shipped, out = fa._fwd, {}
    try:
        for name, fn in fns.items():
            fa._fwd = lambda dtype, fn=fn: fn
            out[name] = run()
    finally:
        fa._fwd = shipped
    torch.cuda.synchronize()
    return out


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_flash_fwd_bits: torch.cuda.is_available() is false; this runs on a "
              "CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()}")
    fns = {"checkout": fa._fwd(torch.float32), "other": build_other(Path(argv[0]).resolve())}
    differ = []

    def report(label, outs):
        a, b = outs["checkout"], outs["other"]
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"{label}: {'equal bit for bit' if same else 'DIFFER'}")
        if not same:
            differ.append(label)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = chip_smoke.FLASH_CASES + chip_smoke.EXTRA_CASES + list(chip_smoke.FLASH_MAIN.values())
    for b, h, kv, s, d, causal, window in cases:
        q, k, v = chip_smoke.qkv(gen, b, h, kv, s, d, torch.float32)
        for lse in (False, True):
            report(f"flash fp32 B{b} H{h} KV{kv} S{s} D{d} causal={causal} window={window} "
                   f"lse={lse}", both(fns, lambda: fa.flash_attention_cuda(
                       q, k, v, causal=causal, window=window, return_lse=lse)))
    for arch in ("smollm-360m", "recurrentgemma-2b"):
        engine = ServeEngine(arch, tiny=False, seed=0, device="cuda")
        cfg = engine.cfg.replace(dtype="float32")
        params = tree_map_with_path(lambda _, t: t.float(),
                                    chip_smoke.true_fan_in(engine.params, engine.cfg))
        tokens = engine.synthetic_prompts(8, 512).cuda()
        del engine
        report(f"{arch} fp32 prefill last logits (B8 S512)",
               both(fns, lambda: chip_smoke.last_logits(cfg, params, tokens, None)))
        del params
        torch.cuda.empty_cache()
    print(f"{len(differ)} differ" + (f": {differ}" if differ else ""))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
