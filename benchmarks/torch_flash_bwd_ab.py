#!/usr/bin/env python3
"""The port's flash-attention backward against another tree's, both routes,
on one NVIDIA H100. Run from the root of a checkout:

    python3 benchmarks/torch_flash_bwd_ab.py OTHER_DIR

OTHER_DIR holds another checkout of the repo, for example a parent commit
unpacked by ``git archive`` under the ignored ``build/``. Each tree's
backward wrapper (``kernels/flash_attention.py``) builds its own ``csrc/``
into its own ``build/kernels/``, and both run on the same inputs:

- on every case of ``chip_smoke.BWD_CASES`` and ``BWD_CASES_D256`` and
  every ``BWD_MAIN`` shape, whether this tree's dK and dV with the dK/dV
  walk unsplit (P = 1) equal the other tree's bit for bit, and whether
  they do at this tree's planned P, the other tree's forced to the same P
  where it takes a split; apart from them, whether dQ does, and each tree's dQ error
  against the plain backward (``ref.flash_attention_bwd_ref``) over the
  largest magnitude of dQ (the fused route sums dQ in another order);
- at the ``BWD_MAIN`` shapes in bf16, and at ``BWD_FP32``'s and qwen2.5's
  in fp32, the device time of one call (``chip_smoke.device_ms``: a
  replayed CUDA graph) of the other tree, this tree at its planned P, this
  tree again and the other again, in that order.

Prints the card first. Exits non-zero without a card.
"""

from __future__ import annotations

import importlib.util
import inspect
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

FP32_TIMED = (*chip_smoke.BWD_FP32, "qwen2.5 train B8 S512")


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
        print("usage: torch_flash_bwd_ab.py OTHER_DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: torch.cuda.is_available() is false; this runs on a CUDA "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    other = other_tree(Path(argv[0]).resolve())
    unsplit = {"split": 1} if "split" in inspect.signature(
        other.flash_attention_bwd_cuda).parameters else {}
    print(f"card: {chip_smoke.card_line()}; other tree: {argv[0]}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        shapes = [(f"B{b} H{h} KV{kv} Sq{sq} Skv{skv} D{d} causal={c} window={w} q_offset={o}",
                   (b, h, kv, sq, skv, d), dict(causal=c, window=w, q_offset=o))
                  for b, h, kv, sq, skv, d, c, w, o in chip_smoke.BWD_CASES
                  + chip_smoke.BWD_CASES_D256]
        shapes += [(label, (b, h, kv, s, s, d), dict(causal=c, window=0, q_offset=0))
                   for label, (b, h, kv, s, d, c) in chip_smoke.BWD_MAIN.items()]
        for label, (b, h, kv, sq, skv, d), kw in shapes:
            q, k, v, do = chip_smoke.grad_inputs(gen, b, h, kv, sq, skv, d, dtype)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            theirs = other.flash_attention_bwd_cuda(q, k, v, o, do, lse, **unsplit, **kw)
            mine = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, split=1, **kw)
            planned = fa.bwd_plan(q, k, **kw)
            mine_planned = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            theirs_planned = (other.flash_attention_bwd_cuda(q, k, v, o, do, lse, split=planned,
                                                             **kw) if unsplit else theirs)
            want_dq = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)[0].float()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b_) for a, b_ in zip(mine[1:], theirs[1:]))
            same_planned = all(torch.equal(a, b_)
                               for a, b_ in zip(mine_planned[1:], theirs_planned[1:]))
            rel = [(g.float() - want_dq).abs().max().item() / want_dq.abs().max().item()
                   for g in (mine[0], mine_planned[0], theirs[0])]
            print(f"bits {dt} {label}: dK/dV P=1 {'equal' if same else 'NOT equal'} to the "
                  f"other tree's; planned P={planned} {'equal' if same_planned else 'NOT equal'}; "
                  f"dQ P=1 {'equal' if torch.equal(mine[0], theirs[0]) else 'not equal'}, "
                  f"max_abs_err/max|dQ| against plain: this P=1 {rel[0]:.2e}, planned "
                  f"{rel[1]:.2e}, other {rel[2]:.2e} (tol {chip_smoke.BWD_TOL[dtype]:g})")
            timed = label in chip_smoke.BWD_MAIN and (dtype == torch.bfloat16
                                                      or label in FP32_TIMED)
            if not timed:
                continue
            iters = 10 if sq > 1024 or dtype == torch.float32 else 50
            runs = {"other": lambda: other.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                                    **unsplit, **kw),
                    "this": lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)}
            times = [(name, chip_smoke.device_ms(runs[name], iters=iters))
                     for name in ("other", "this", "this", "other")]
            print(f"time {dt} {label} (this tree at P={planned}): "
                  + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
