"""bench/flops.py against PyTorch's own count of the reference's products,
and the frozen attention bounds against the figures they were taken from."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import data, flops
from bench.reference import model as ref
from bench.tests.conftest import tiny_spec


@pytest.mark.parametrize("config", ["smollm-360m", "granite-moe-3b-a800m"])
def test_train_flops_match_the_counted_products(config, one_thread):
    spec = tiny_spec(config, batch=2, seq=24)
    cfg = spec["config"]
    if "num_local_experts" in cfg:  # no row dropped: every token takes top_k experts
        cfg["capacity_factor"] = float(cfg["num_local_experts"])
    b, s = spec["traffic"]["batch"], spec["traffic"]["seq"]
    batch = data.make(spec["traffic"], cfg["vocab_size"], 5)(0)
    params = ref.init(cfg, 5, "cpu")
    with FlopCounterMode(display=False) as counter:
        loss, _ = ref.loss_fn(params, torch.as_tensor(batch["tokens"]).long(),
                              torch.as_tensor(batch["labels"]).long(), cfg, remat=False)
        torch.autograd.grad(loss, [t for _, t in ref.leaves(params)])
    # the reference computes every (query, key) score and masks it: count S^2 pairs
    want = flops.train_flops_per_token(cfg, s, pairs=s * s) * b * s
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-12)


def test_causal_pairs_are_half_the_square_and_the_diagonal():
    assert flops.unmasked_pairs(2048, 2048, True, 0) == 2048 * 2049 // 2
    assert flops.unmasked_pairs(512, 512, False, 0) == 512 * 512
    assert flops.unmasked_pairs(8, 8, True, 3) == 1 + 2 + 3 * 6


def test_attention_bounds_are_the_kernel_tables():
    # B8 H15 KV5 S512 D64 bf16 causal: the forward 0.0063 ms from 20.97 MB
    # and 4.03 GFLOP, the backward 0.0126 ms (the port's kernel table)
    fwd = flops.attention_bound(8, 15, 5, 512, 64, True, 0, "bfloat16")
    bwd = flops.attention_bwd_bound(8, 15, 5, 512, 64, True, 0, "bfloat16")
    assert round(fwd["bound_ms"], 4) == 0.0063 and fwd["bound_by"] == "bytes"
    assert round(fwd["bytes"] / 1e6, 2) == 20.97 and round(fwd["flops"] / 1e9, 2) == 4.03
    assert round(bwd["bound_ms"], 4) == 0.0126
    s2048 = flops.attention_bound(8, 15, 5, 2048, 64, True, 0, "bfloat16")
    assert round(s2048["bound_ms"], 4) == 0.0652 and s2048["bound_by"] == "operations"


def test_step_flops_of_the_cells():
    import json
    from bench.tests.conftest import ROOT
    smollm = json.loads((ROOT / "bench/configs/smollm-360m.json").read_text())
    granite = json.loads((ROOT / "bench/configs/granite-moe-3b-a800m.json").read_text())
    assert flops.train_flops_per_token(smollm, 2048) == pytest.approx(2.548224e9)
    assert flops.train_flops_per_token(smollm, 512) == pytest.approx(2.26510848e9)
    assert flops.train_flops_per_token(granite, 2048) == pytest.approx(5.900921856e9)
