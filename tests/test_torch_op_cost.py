"""``repro_torch.launch.op_cost`` (the port's counterpart of the reference's
``launch/hlo_cost.py``) and the kernels' meta route, mirroring
``tests/test_hlo_cost.py``: a loop-free product counted exactly, a Python
loop multiplying the count, the stacked and list layouts counting alike, a
collective in a loop of 10 counting 10 times its bytes and a column-split
product on a fake 1x4 mesh counting a quarter of the global product (these
two in a process of their own, ``tests/_torch_dryrun_worker.py``). Then the
flash and scan shape functions: the kernels' own FLOPs, no score matrix,
``force`` kept as it was."""

import pytest
import torch

import _torch_dryrun_worker as W

from repro_torch.configs import get_tiny_config
from repro_torch.kernels import cost, ops
from repro_torch.launch.op_cost import analyze
from repro_torch.models import steps
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import place_abstract


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.fixture(scope="module")
def fake_mesh(tmp_path_factory):
    """The cases on a fake 1x4 mesh, run once in a process of their own."""
    return W.spawn(["collective_loop", "column_split"], str(tmp_path_factory.mktemp("opc")),
                   timeout=120)


def _ok(results, case):
    assert case in results, f"{case}: the worker did not finish it"
    assert "error" not in results[case], results[case]["error"]
    return results[case]


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_loopfree_product_counted_exactly(device):
    def f(x, w1, w2):
        return torch.tanh(x @ w1) @ w2

    args = [torch.empty(s, device=device) for s in ((512, 256), (256, 1024), (1024, 128))]
    res = analyze(f, *args)
    assert res["flops"] == 2 * 512 * 256 * 1024 + 2 * 512 * 1024 * 128
    # operands plus results of the two products and the tanh, fp32
    want = 4 * ((512 * 256 + 256 * 1024 + 512 * 1024) + 2 * 512 * 1024
                + (512 * 1024 + 1024 * 128 + 512 * 128))
    assert res["bytes"] == want
    assert res["collective_bytes"] == 0 and not any(res["collective_counts"].values())
    inputs = 4 * (512 * 256 + 256 * 1024 + 1024 * 128)
    assert res["arg_bytes"] == inputs
    # the product and its tanh live together; the product is freed before the second
    assert res["peak_bytes"] == inputs + 2 * 4 * 512 * 1024


@pytest.mark.parametrize("n", [2, 8, 32])
def test_loop_multiplies_the_count(n):
    def g(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return x

    res = analyze(g, meta(256, 256), meta(n, 256, 256))
    assert res["flops"] == n * 2 * 256 ** 3


def test_stacked_and_list_layouts_count_alike():
    """A stacked layer stack costs what its list twin costs (the reference's
    scanned-against-unrolled test)."""
    cfg0 = get_tiny_config("smollm-360m").replace(n_layers=4, attn_chunk=64)
    batch = {k: meta(2, 64, dtype=torch.int32) for k in ("tokens", "labels")}
    opt = adamw.AdamWConfig(total_steps=10)
    flops = {}
    for scan in (True, False):
        cfg = cfg0.replace(scan_layers=scan)
        state = place_abstract(steps.abstract_train_state(cfg), None)
        flops[scan] = analyze(steps.make_train_step(cfg, opt), state, batch)["flops"]
    assert flops[True] == flops[False]


def test_collective_in_a_loop_counts_each_time(fake_mesh):
    res = _ok(fake_mesh, "collective_loop")
    assert res["collective_counts"]["all-reduce"] == 10
    assert res["collectives"]["all-reduce"] == 10 * 16 * 16 * 4
    assert res["collective_bytes"] == 10 * 16 * 16 * 4


def test_column_split_counts_one_rank(fake_mesh):
    res = _ok(fake_mesh, "column_split")
    assert res["flops"] == 2 * 64 * 256 * 512 / 4
    assert res["collective_bytes"] == 0


MASKS = {"causal": dict(causal=True, window=0), "window": dict(causal=True, window=24),
         "bidirectional": dict(causal=False, window=0)}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_meta_route_counts_the_kernel(mask, dtype):
    """Forward then backward through the dispatcher on meta tensors: one
    forward and one backward kernel call, 4·D and 10·D a kept pair and head,
    and no (B, H, S, S) fp32 scores at any time."""
    b, h, kv, s, d = 2, 4, 2, 1024, 16
    kw = MASKS[mask]
    q, k, v = meta(b, h, s, d, dtype=dtype, grad=True), \
        meta(b, kv, s, d, dtype=dtype, grad=True), meta(b, kv, s, d, dtype=dtype, grad=True)

    def step(q, k, v):
        o = ops.flash_attention(q, k, v, **kw)
        torch.autograd.grad(o.float().sum(), (q, k, v))

    res = analyze(step, q, k, v)
    pairs = cost.unmasked_pairs(s, s, kw["causal"], kw["window"])
    assert pairs == {"causal": s * (s + 1) // 2, "bidirectional": s * s,
                     "window": sum(min(i + 1, 24) for i in range(s))}[mask]
    kern = res["kernels"]
    assert kern["flash_attention"] == {"calls": 1, "flops": 4 * d * pairs * b * h,
                                       "bytes": kern["flash_attention"]["bytes"]}
    assert kern["flash_attention_bwd"]["calls"] == 1
    assert kern["flash_attention_bwd"]["flops"] == 10 * d * pairs * b * h
    isz = torch.empty((), dtype=dtype).element_size()
    assert kern["flash_attention"]["bytes"] == (2 * b * h * s * d + 2 * b * kv * s * d) * isz \
        + 4 * b * h * s
    assert res["flops"] == 14 * d * pairs * b * h  # nothing else multiplies
    assert res["peak_bytes"] < 4 * b * h * s * s


def test_flash_meta_route_under_no_grad_and_force():
    q, k = meta(1, 2, 64, 32), meta(1, 2, 64, 32)
    with torch.no_grad():
        res = analyze(lambda q, k: ops.flash_attention(q, k, k), q, k)
    assert res["kernels"]["flash_attention"]["calls"] == 1
    assert ops.launch_counts()["flash_attention"] == 0  # a shape function launches nothing
    # force="ref" on meta takes the plain version: its products, at every pair
    ref = analyze(lambda q, k: ops.flash_attention(q, k, k, causal=False, force="ref"), q, k)
    assert not ref["kernels"] and ref["flops"] == 4 * 32 * 64 * 64 * 2
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16),
                            torch.zeros(1, 2, 8, 16), force="kernel")
    with pytest.raises(ValueError, match="head_dim"):  # the kernel's own checks hold on meta
        ops.flash_attention(meta(1, 2, 8, 24), meta(1, 2, 8, 24), meta(1, 2, 8, 24))


@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_meta_route_counts_2_and_3_an_element(with_h0):
    b, s, w = 2, 48, 40
    a, x = meta(b, s, w, grad=True), meta(b, s, w, grad=True)
    h0 = meta(b, w, grad=True) if with_h0 else None

    def step(a, x, h0):
        h, last = ops.rglru_scan(a, x, h0)
        torch.autograd.grad((h.sum() + last.sum()), [t for t in (a, x, h0) if t is not None])

    res = analyze(step, a, x, h0)
    kern = res["kernels"]
    assert kern["rglru_scan"]["flops"] == 2 * b * s * w
    assert kern["rglru_scan_bwd"]["flops"] == 3 * b * s * w
    assert kern["rglru_scan"]["bytes"] == 4 * (3 * b * s * w + b * w + (b * w if with_h0 else 0))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), force="kernel")
