"""The plain reference against the port's plain path on the CPU at a tiny
width (a test of the reference, not the oracle of a run): in fp32 the two
agree to rounding on every number the benchmark compares, capacity drops
included, through a whole run of the harness."""

import time

import pytest
import torch

from bench import harness
from bench.tests.conftest import tiny_spec

CELLS = [("smollm-360m", "smollm-360m.train-b16-s2048"),
         ("granite-moe-3b-a800m", "granite-moe-3b-a800m.train-b4-s2048")]


@pytest.mark.parametrize("config,cell", CELLS)
def test_reference_follows_the_port_in_fp32(config, cell, one_thread):
    spec = tiny_spec(config, "float32", cell, batch=4, seq=32)
    spec["config"]["capacity_factor"] = 0.5  # rows dropped (next test)
    spec["limits"] = {k: 2e-6 for k in spec["limits"]}
    out, _ = harness.run_cell(spec, 2 ** 33 + 7, 0.0, False, torch.device("cpu"), time.time(),
                           log=lambda msg: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] == spec["traffic"]["steps_per_sync"]
    assert list(out)[-1] == "checks"


def test_capacity_drops_rows_in_the_tiny_moe_batch():
    from bench import data
    from bench.reference import model as ref
    spec = tiny_spec("granite-moe-3b-a800m", "float32", CELLS[1][1], batch=4, seq=32)
    cfg = {**spec["config"], "capacity_factor": 0.5}
    params = ref.init(cfg, 2 ** 33 + 7, "cpu")
    x = torch.nn.functional.embedding(
        torch.as_tensor(data.make(spec["traffic"], cfg["vocab_size"], 2 ** 33 + 7)(0)["tokens"]
                        ).long(), params["embed"]).reshape(-1, cfg["hidden_size"])
    probs = torch.softmax(x @ params["router"][0], -1)
    counts = torch.bincount(torch.topk(probs, 2, -1).indices.reshape(-1), minlength=5)
    cap = ref.capacity(x.shape[0], 2, 5, cfg["capacity_factor"])
    assert int(counts.max()) > cap  # the comparison above covers dropped rows


def test_seeded_weights_repeat_and_differ_by_seed():
    from bench.weights import draw
    cfg = tiny_spec()["config"]
    a, b = draw(cfg, "wq", 2 ** 40, "cpu"), draw(cfg, "wq", 2 ** 40, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, draw(cfg, "wq", 2 ** 40 + 1, "cpu"))
    assert float(a.std()) == pytest.approx(64 ** -0.5, rel=0.05)
