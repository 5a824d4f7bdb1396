"""Shared pieces of the benchmark's CPU tests: tiny specs of the cells'
configurations, run through the harness on the CPU."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_spec(config="smollm-360m", dtype="float32", cell="smollm-360m.train-b16-s2048",
              batch=2, seq=32):
    """A cell's spec at a tiny width: its configuration file with small
    widths, its traffic at a small batch, its own limits."""
    from bench import harness
    spec = harness.load_spec(cell)
    base = json.loads((ROOT / "bench" / "configs" / f"{config}.json").read_text())
    moe = "num_local_experts" in base
    base.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=48 if moe else 128, vocab_size=256,
                torch_dtype=dtype)
    if moe:
        base.update(num_local_experts=5, num_experts_per_tok=2)
    spec["config"] = base
    spec["traffic"] = {**spec["traffic"], "batch": batch, "seq": seq}
    return spec


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
