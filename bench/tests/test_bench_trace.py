"""The per-layer readers and the trace's reductions on a record made by
hand: what each reads, and that a reader with nothing to read returns
nothing."""

import json
import runpy

import pytest

from bench import flops, trace
from bench.tests.conftest import ROOT

CONFIG = json.loads((ROOT / "bench/configs/smollm-360m.json").read_text())
TRAFFIC = json.loads((ROOT / "bench/traffic/train-b16-s2048.json").read_text())


def reader(name):
    return runpy.run_path(str(ROOT / "bench" / "metrics" / f"{name}.py"))["read"]


def record(ops, window=(0, 1000), host=()):
    return {"window_ns": window, "device_ops": sorted(ops),
            "kernels": [r for r in sorted(ops) if not trace.NOT_KERNEL.match(r[0])],
            "host": list(host)}


def ctx(rec, steps=2):
    return {"record": rec, "steps": steps, "config": CONFIG, "traffic": TRAFFIC,
            "flops_per_step": 1e9, "peak_flops": 1e12}


OPS = [("void flash_fwd_sm90_kernel<64>(Params)", 100, 200), ("flash_bwd_delta_sm90", 200, 260),
       ("ampere_bf16_gemm", 250, 400), ("Memcpy HtoD (Pageable -> Device)", 500, 520),
       ("elementwise_kernel", 700, 800)]


def test_launches_count_kernels_not_copies():
    assert reader("launches_per_step")(ctx(record(OPS))) == 2.0
    assert reader("launches_per_step")(ctx(record([]))) is None


def test_idle_is_the_window_outside_the_union():
    # busy: [100, 400) + [500, 520) + [700, 800) = 420 of 1000
    assert reader("device_idle_pct")(ctx(record(OPS))) == pytest.approx(58.0)
    assert reader("device_idle_pct")(ctx(record([]))) is None
    assert trace.busy_ns(record(OPS)) == 420


def test_attention_roofline_is_the_cells_bound_over_flash_time():
    shape = (16, 15, 5, 2048, 64, True, 0, "bfloat16")
    bound_ms = (flops.attention_bound(*shape)["bound_ms"]
                + flops.attention_bwd_bound(*shape)["bound_ms"]) * 32 * 2
    want = 100 * bound_ms / (160 / 1e6)  # 100 + 60 ns of flash_* kernels
    assert reader("attention_kernels.roofline_pct")(ctx(record(OPS))) == pytest.approx(want)
    assert reader("attention_kernels.roofline_pct")(ctx(record(OPS[2:]))) is None


def test_step_mfu_is_model_flops_over_the_window_at_peak():
    # 2 steps of 1e9 FLOP in 1000 ns at 1e12 FLOP/s
    assert reader("step_mfu")(ctx(record(OPS))) == pytest.approx(100 * 2e9 / (1e-6 * 1e12))


def test_breakdown_names_gaps_by_the_host_op(monkeypatch):
    monkeypatch.setattr(trace, "NAMED_GAP_NS", 50)
    host = [("aten::item", 820, 990, 1), ("cudaStreamSynchronize", 830, 985, 1),
            ("aten::copy_", 400, 500, 2)]
    gaps = dict(trace.idle_gaps(record(OPS, host=host)))
    assert gaps["cudaStreamSynchronize"] == pytest.approx(200e-9)  # [800, 1000)
    assert gaps["aten::copy_"] == pytest.approx(100e-9)  # [400, 500)
    assert gaps["(no host op)"] == pytest.approx(100e-9 + 180e-9)  # [0, 100), [520, 700)
    top = trace.top_device_ops(record(OPS))
    assert top[0] == ["ampere_bf16_gemm", pytest.approx(150e-9)]
