"""A whole run of the harness on the CPU (the look for a card skipped) with
the timed path broken underneath: each fault a one-card training cell can
have comes out not correct under the cell's own limits, and the sound run
comes out correct."""

import time

import pytest
import torch

from bench import harness
from bench.tests.conftest import tiny_spec

CELLS = ["smollm-360m.train-b16-s2048", "granite-moe-3b-a800m.train-b4-s2048",
         "smollm-360m.train-b64-s512"]


def config_of(cell):
    return cell.split(".")[0]


def port_step(spec):
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    cfg = harness.port_config(spec["config"])
    return steps.make_train_step(cfg, adamw.AdamWConfig(**spec["traffic"]["optimizer"]))


def unchanged(spec):
    """A step that computes the loss and returns its state as it was."""
    from repro_torch.models import steps
    cfg = harness.port_config(spec["config"])
    loss_of = steps.make_eval_step(cfg)

    def step(state, batch):
        loss = loss_of(state.params, batch)["loss"]
        return state, {"loss": loss, "grad_norm": torch.ones(())}
    return step


def half_batch(spec):
    """The batch's second half left out, the mean taken over the rest."""
    real = port_step(spec)
    return lambda state, batch: real(state, {k: v[: len(v) // 2] for k, v in batch.items()})


def one_kind_moved_double(spec):
    """An answer altered where it is produced: the last leaf's update
    applied twice."""
    from repro_torch.utils.trees import tree_flatten_with_paths
    real = port_step(spec)

    def step(state, batch):
        path, master = tree_flatten_with_paths(state.opt.master)[-1]
        before = master.clone()
        state, metrics = real(state, batch)
        master.add_(master - before)
        dict(tree_flatten_with_paths(state.params))[path].copy_(master)
        return state, metrics
    return step


def run(spec, step_fn=None):
    return harness.run_cell(spec, 2 ** 32 + 11, 0.0, False, torch.device("cpu"), time.time(),
                            step_fn=step_fn, log=lambda msg: None)[0]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, unchanged, half_batch, one_kind_moved_double])
def test_faults_fail_the_cells_limits(cell, fault, one_thread):
    spec = tiny_spec(config_of(cell), "float32", cell, batch=4, seq=32)
    out = run(spec, fault(spec) if fault else None)
    assert out["correct"] is (fault is None), out["checks"]
