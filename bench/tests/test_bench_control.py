"""The control at a size a test run holds: the reference with every product
in fp8 (one precision below the configurations' bf16), put in the program's
place, fails each cell's limits; the program's bf16 steps of a dense cell
pass them at the same size."""

import time

import pytest
import torch

from bench import harness
from bench.tests.conftest import tiny_spec

CELLS = ["smollm-360m.train-b16-s2048", "granite-moe-3b-a800m.train-b4-s2048",
         "smollm-360m.train-b64-s512"]


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails_the_cells_limits(cell, one_thread):
    spec = tiny_spec(cell.split(".")[0], "bfloat16", cell, batch=4, seq=64)
    cpu = torch.device("cpu")
    ref = harness.reference_readings(spec, 2 ** 31 + 17, cpu)
    control = harness.reference_readings(spec, 2 ** 31 + 17, cpu, quant=True)
    checks = harness.compare(control, ref, spec["limits"])
    assert not harness.judged(checks), checks


def test_bf16_program_passes_a_dense_cells_limits(one_thread):
    cell = CELLS[0]
    spec = tiny_spec("smollm-360m", "bfloat16", cell, batch=4, seq=64)
    out, _ = harness.run_cell(spec, 2 ** 31 + 17, 0.0, False, torch.device("cpu"), time.time(),
                           log=lambda msg: None)
    assert out["correct"], out["checks"]
