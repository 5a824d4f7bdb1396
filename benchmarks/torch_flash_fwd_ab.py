#!/usr/bin/env python3
"""The port's bf16 flash forward against another tree's, on one NVIDIA
H100. Run from the root of a checkout:

    python3 benchmarks/torch_flash_fwd_ab.py OTHER_DIR

OTHER_DIR holds another checkout of the repo, for example a parent commit
unpacked by ``git archive`` under the ignored ``build/``. Each tree's
forward wrapper (``kernels/flash_attention.py``) builds its own ``csrc/``
into its own ``build/kernels/``, and both run on the same inputs:

- on every bf16 forward case of ``chip_smoke.py``
  (``chip_smoke.fwd_bf16_cases``: ``FLASH_CASES``, ``EXTRA_CASES``, the
  q_offset suffix, the ragged cases at every head dim and every
  ``FLASH_MAIN`` shape), whether this tree's O without the rows' lse, its
  O with it and its lse equal the other tree's bit for bit, whether its O
  with lse equals its O without, and whether two of its launches are
  equal;
- at the ``FLASH_MAIN`` shapes, the device time of one call
  (``chip_smoke.device_ms``: a replayed CUDA graph) of the other tree,
  this tree, this tree again and the other again, in that order.

Prints the card first. Exits non-zero without a card or on any differing
bit.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def other_tree(root: Path):
    """The other tree's flash_attention module, building from its own csrc/."""
    kernels = root / "src" / "repro_torch" / "kernels"
    other = load("other_flash_attention", kernels / "flash_attention.py")
    other._build = load("other_build", kernels / "_build.py")
    return other


def main(argv) -> int:
    if len(argv) != 1 or not Path(argv[0]).is_dir():
        print("usage: torch_flash_fwd_ab.py OTHER_DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_flash_fwd_ab: torch.cuda.is_available() is false; this runs on a CUDA "
              "card", file=sys.stderr)
        return 1
    other = other_tree(Path(argv[0]).resolve())
    print(f"card: {chip_smoke.card_line()}; other tree: {argv[0]}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    differ = []
    for label, (b, h, kv, sq, skv, d), kw in chip_smoke.fwd_bf16_cases():
        q, k, v = chip_smoke.qkv(gen, b, h, kv, sq, d, torch.bfloat16, skv=skv)
        mine = fa.flash_attention_cuda(q, k, v, **kw)
        mine_o, mine_lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        again = fa.flash_attention_cuda(q, k, v, **kw)
        theirs = other.flash_attention_cuda(q, k, v, **kw)
        theirs_o, theirs_lse = other.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        checks = {"O": torch.equal(mine, theirs), "O with lse": torch.equal(mine_o, theirs_o),
                  "lse": torch.equal(mine_lse, theirs_lse)}
        own = {"O with lse = O": torch.equal(mine_o, mine), "two launches": torch.equal(mine, again)}
        bad = [name for name, same in {**checks, **own}.items() if not same]
        print(f"bits {label} D{d}: O, O with lse and lse "
              f"{'equal' if all(checks.values()) else 'NOT equal'} to the other tree's; "
              f"O with lse {'equals' if own['O with lse = O'] else 'DIFFERS from'} O without; "
              f"two launches {'equal' if own['two launches'] else 'DIFFER'}")
        if bad:
            differ.append(f"{label}: {', '.join(bad)}")
        if label not in chip_smoke.FLASH_MAIN:
            continue
        runs = {"other": lambda: other.flash_attention_cuda(q, k, v, **kw),
                "this": lambda: fa.flash_attention_cuda(q, k, v, **kw)}
        times = [(name, chip_smoke.device_ms(runs[name])) for name in ("other", "this", "this",
                                                                        "other")]
        print(f"time bf16 {label}: " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times))
    print(f"{len(differ)} cases differ" + (f": {differ}" if differ else ""))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
