"""On the card (``gpu``; skips without one): a whole run of the harness at a
tiny width, the window and the profiled group, through the port's kernels."""

import time

import pytest
import torch

from bench import harness
from bench.tests.conftest import tiny_spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_on_the_card(card, trace):
    spec = tiny_spec("granite-moe-3b-a800m", "bfloat16", "granite-moe-3b-a800m.train-b4-s2048",
                     batch=4, seq=128)
    spec["limits"] = {k: 0.1 for k in spec["limits"]}
    out, _ = harness.run_cell(spec, 2 ** 31 + 3, 0.5, trace, card, time.time(),
                           log=lambda msg: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    if trace:
        assert out["metrics"]["attention_kernels.roofline_pct"]["value"] > 0
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    else:
        assert out["metrics"]["train_tokens_per_s"]["value"] > 0
