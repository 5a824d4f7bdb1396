"""The port's kernels (repro_torch.kernels: flash attention and the RG-LRU
scan) against the JAX package's: the plain PyTorch versions against
``kernels/ref.py`` and the Pallas kernels in interpret mode, the
dispatchers' routing and launch counters, and, on a card only, the CUDA
kernels against their plain versions.

Inputs are made with numpy from a fixed seed and handed to both packages;
JAX stays on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ref as jref
from repro.kernels.ops import flash_attention as jax_flash
from repro.kernels.ops import rglru_scan as jax_rglru_scan
from repro.nn.attention import flash_attention as jax_chunked_twin
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import (
    BWD_ROUTES,
    HEAD_DIMS,
    ROUTES,
    bwd_smem_bytes,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.rglru import rglru_scan_bwd_cuda, rglru_scan_cuda
from repro_torch.nn import attention

# (B, H, KV, S, D, causal, window), as in tests/test_kernels.py
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, 0),     # GQA causal
    (1, 8, 8, 128, 128, True, 0),    # MHA, wide head
    (2, 4, 1, 256, 64, True, 64),    # MQA + local window
    (1, 2, 2, 128, 64, False, 0),    # bidirectional (encoder)
    (1, 15, 5, 128, 64, True, 0),    # smollm-style 15H/5KV grouping
    (2, 2, 2, 512, 32, True, 128),   # long window
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# (B, S, W), as in tests/test_kernels.py, and lengths no Pallas block divides,
# among them the edges of the CUDA kernel's ring (16-lane tiles, 64-step
# stages, TMA only where a row is a multiple of 16 bytes)
RGLRU_CASES = [(8, 256, 128), (2, 512, 256), (1, 128, 512), (16, 64, 128)]
RGLRU_RAGGED = [(3, 100, 200), (1, 37, 96),
                (2, 1, 256),    # one step
                (2, 40, 128),   # fewer steps than one stage
                (1, 200, 64),   # steps not a multiple of the stage
                (2, 70, 37),    # odd width: rows off 16 bytes, a ragged lane tile
                (1, 1, 37),     # both
                (5, 64, 24),    # the last block of each row half empty
                (2, 65, 36),    # fp32 rows on 16 bytes, bf16 rows not
                (1, 700, 40)]   # the ring wraps
RGLRU_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv_np(b, h, kv, sq, d, skv=None, seed=0):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, kv, skv, d), np.float32),
            rng.standard_normal((b, kv, skv, d), np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_ref(b, h, kv, s, d, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv_np(b, h, kv, s, d), dtype)
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_q_offset_suffix_matches_jax_ref(dtype):
    """q as a suffix of the kv sequence (tests/test_kernels.py:60)."""
    b, h, s, d = 1, 4, 256, 64
    q_np, k_np, v_np = _qkv_np(b, h, h, s, d)
    (jq, jk, jv), (q, k, v) = _both((q_np[:, :, -64:], k_np, v_np), dtype)
    out = ref.flash_attention_ref(q, k, v, causal=True, q_offset=s - 64)
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True,
                                         q_offset=s - 64), DTYPES[dtype][2])


@pytest.mark.parametrize("sq,skv,q_offset,window", [(200, 200, 0, 0),
                                                    (37, 100, 63, 32)])
def test_plain_ragged_lengths_match_jax_ref(sq, skv, q_offset, window):
    """Lengths that no 64- or 128-block divides (the Pallas kernel raises
    on them; the port's kernel masks the tail)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv_np(2, 6, 2, sq, 16, skv), "float32")
    kw = dict(causal=True, window=window, q_offset=q_offset)
    _close(ref.flash_attention_ref(q, k, v, **kw),
           jref.flash_attention_ref(jq, jk, jv, **kw), 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_interpret(dtype):
    """The smollm 15H/5KV grouping through the Pallas kernel itself."""
    (jq, jk, jv), (q, k, v) = _both(_qkv_np(1, 15, 5, 128, 64, seed=1), dtype)
    out = ref.flash_attention_ref(q, k, v, causal=True)
    _close(out, jax_flash(jq, jk, jv, causal=True, force="interpret"),
           DTYPES[dtype][2])


# (B, H, KV, Sq, Skv, D, causal, window, q_offset, chunk): several chunks,
# a window across chunks, a chunk that the length picks (200 -> 50), an
# offset suffix
TWIN_CASES = [(2, 4, 2, 256, 256, 64, True, 0, 0, 64),
              (2, 4, 1, 256, 256, 64, True, 96, 0, 64),
              (1, 2, 2, 128, 128, 64, False, 0, 0, 64),
              (1, 15, 5, 200, 200, 16, True, 0, 0, 64),
              (2, 6, 2, 100, 300, 32, True, 96, 200, 512)]


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,q_offset,chunk", TWIN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_attention_matches_jax_chunked_twin(b, h, kv, sq, skv, d, causal, window,
                                                    q_offset, chunk, dtype):
    """The port's copy of the reference model's attention (the oracle that
    ``chip_smoke.py`` holds the bf16 route's rounding to) against
    ``repro/nn/attention.py:flash_attention`` itself."""
    (jq, jk, jv), (q, k, v) = _both(_qkv_np(b, h, kv, sq, d, skv), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)
    _close(attention.chunked_attention(q, k, v, **kw),
           jax_chunked_twin(jq, jk, jv, **kw), DTYPES[dtype][2])


def test_reference_rounding_stays_within_the_bf16_route_bound():
    """The per-layer bound ``chip_smoke.py`` holds the bf16 kernel to
    (TOL plus 2^-8 softmax.|V| for its bf16 probabilities) holds for the
    reference model's own chunked twin, on inputs as large as the default
    init's (|v| up to about 250, nearly one-hot scores), where TOL alone
    does not."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(8 * rng.standard_normal((1, 4, 300, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 300, 64), np.float32))
    v = torch.from_numpy(80 * rng.standard_normal((1, 2, 300, 64), np.float32))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=True, window=128)
    twin = attention.chunked_attention(q, k, v, chunk=64, **kw)
    _, n_outside_bound = chip_smoke.attention_within(twin, q, k, v, **kw)
    assert n_outside_bound == 0
    assert chip_smoke.outside_tol(twin, ref.flash_attention_ref(q, k, v, **kw)) > 0


def test_dispatcher_cpu_uses_plain_and_counts_nothing():
    _, (q, k, v) = _both(_qkv_np(1, 4, 2, 64, 16), "float32")
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    assert ops.launch_counts() == before
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(ops.flash_attention(q, k, v, force="ref"), out)


def test_dispatcher_force_kernel_on_cpu_raises():
    _, (q, k, v) = _both(_qkv_np(1, 4, 2, 64, 16), "float32")
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(q, k, v, force="interpret")
    assert ops.launch_counts() == before


@pytest.mark.parametrize("d,dtype", [(256, torch.float32), (256, torch.bfloat16),
                                     (128, torch.float32)])
def test_bwd_meta_route_takes_every_head_dim_on_both_routes(d, dtype):
    """The backward's shape function on meta tensors (the dry-run's) takes
    head_dim 256 on the fp32 route as on the bf16 one: (dq, dk, dv) shaped
    and typed as q, k, v on meta, no launch, and one kernel call reported
    with its cost: 10·D FLOP a kept (query, key) pair and head, each input
    and output once (q, k, v, o, do, the fp32 lse, dq, dk, dv and the fp32
    Δ scratch)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_meta
    from repro_torch.launch.op_cost import OpCost

    b, h, kv, sq, skv, window, q_offset = 2, 10, 1, 100, 300, 96, 200
    q, o, do = (torch.empty((b, h, sq, d), dtype=dtype, device="meta") for _ in range(3))
    k, v = (torch.empty((b, kv, skv, d), dtype=dtype, device="meta") for _ in range(2))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="meta")
    before = ops.launch_counts()
    counter = OpCost()
    with counter:
        dq, dk, dv = flash_attention_bwd_meta(q, k, v, o, do, lse, causal=True, window=window,
                                              q_offset=q_offset)
    assert ops.launch_counts() == before
    for got, like in ((dq, q), (dk, k), (dv, v)):
        assert got.device.type == "meta" and got.shape == like.shape and got.dtype == dtype
    pairs = chip_smoke.unmasked_pairs(sq, skv, True, window, q_offset)
    isz = torch.empty((), dtype=dtype).element_size()
    assert counter.kernels["flash_attention_bwd"] == {
        "calls": 1, "flops": 10 * d * pairs * b * h,
        "bytes": (4 * b * h * sq * d + 4 * b * kv * skv * d) * isz + 2 * 4 * b * h * sq}


def test_reset_launch_counts():
    flash_attention_cuda.launches = 5
    flash_attention_bwd_cuda.launches = 4
    rglru_scan_cuda.launches = 3
    rglru_scan_bwd_cuda.launches = 2
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "rglru_scan": 0, "rglru_scan_bwd": 0}


# --------------------------------------------------------------------------
# The fp32 route's arithmetic: split-TF32 products (csrc/flash_attention.cu)
# --------------------------------------------------------------------------

def _tf32(x):
    """``cvt.rna.tf32.f32`` on the int32 bits of fp32 ``x``: keep 10 mantissa
    bits, rounding the magnitude to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq, x, y, products):
    """x.y in fp32 from TF32 operands: with 3 products each operand is split
    into hi = tf32(x) and lo = tf32(x - hi), summed lo.hi' + hi.lo' + hi.hi'
    (small terms first) as the kernel's mma triple does; with 1, hi.hi'."""
    x_hi, y_hi = _tf32(x), _tf32(y)
    if products == 1:
        return torch.einsum(eq, x_hi, y_hi)
    x_lo, y_lo = _tf32(x - x_hi), _tf32(y - y_hi)
    return (torch.einsum(eq, x_lo, y_hi) + torch.einsum(eq, x_hi, y_lo)
            + torch.einsum(eq, x_hi, y_hi))


def _tf32_attention(q, k, v, *, causal, window, q_offset=0, products=3):
    """A model of the fp32 route's arithmetic (not of its tile schedule):
    q scaled in fp32 and then split, both products from TF32 operands, the
    fp32 probabilities split for P.V, the output acc / max(l, 1e-30)."""
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, sq, d).float() * (d ** -0.5)
    s = _tf32_product("bkgsd,bkcd->bkgsc", qg, k.float(), products)
    q_pos = q_offset + torch.arange(sq)
    k_pos = torch.arange(skv)
    if causal:
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], ref.NEG_INF)
    if window > 0:
        s = s.masked_fill(q_pos[:, None] - k_pos[None, :] >= window, ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = _tf32_product("bkgsc,bkcd->bkgsd", p, v.float(), products)
    o = acc / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return o.reshape(b, h, sq, d)


# FLASH_CASES plus head_dim 16 and recurrentgemma's head_dim 256 with MQA and
# a window, at lengths no tile divides
SPLIT_TF32_CASES = FLASH_CASES + [(2, 4, 2, 200, 16, True, 0),
                                  (1, 10, 1, 300, 256, True, 96)]


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", SPLIT_TF32_CASES)
def test_split_tf32_products_hold_fp32_tolerance(b, h, kv, s, d, causal, window):
    """Three TF32 products per fp32 product meet fp32's 2e-5 against the JAX
    reference: why the fp32 route may run on the tensor cores."""
    arrays = _qkv_np(b, h, kv, s, d, seed=4)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    _close(_tf32_attention(q, k, v, causal=causal, window=window),
           jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window), 2e-5)


def test_one_tf32_product_misses_fp32_tolerance():
    """One TF32 product (hi.hi' alone) misses 2e-5 by far: why the fp32 route
    splits its operands."""
    (jq, jk, jv), (q, k, v) = _both(_qkv_np(1, 15, 5, 256, 64, seed=4), "float32")
    want = jref.flash_attention_ref(jq, jk, jv, causal=True)
    one = _tf32_attention(q, k, v, causal=True, window=0, products=1)
    with pytest.raises(AssertionError):
        _close(one, want, 2e-5)
    assert np.abs(one.numpy() - np.asarray(want)).max() > 10 * 2e-5


@pytest.mark.parametrize("table,dtype", [(t, d) for t in ("forward", "backward")
                                         for d in (torch.bfloat16, torch.float32)])
def test_route_tables_name_sources_with_their_entry_points(table, dtype):
    """Each route of the forward and the backward names a source in csrc/
    whose C entry points (``<source>_fwd`` or ``<source>``, and
    ``<source>_smem_bytes``) the wrappers bind by that name."""
    source, _ = (ROUTES if table == "forward" else BWD_ROUTES)[dtype]
    text = (_build.CSRC / f"{source}.cu").read_text()
    entry = f"{source}_fwd" if table == "forward" else source
    assert f'extern "C" int {entry}(' in text
    assert f'extern "C" int {source}_smem_bytes(int D)' in text


def test_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes every library's file name, so a
    stale build of a source that includes it is never loaded."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("a")
    assert first == _build.library_path("a")
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _build.library_path("a") != first


def test_tf32_rounding_is_nearest_ties_away():
    """The emulation's rounding: 10 mantissa bits kept, ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 3 * ulp / 2, 3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0]


# --------------------------------------------------------------------------
# The backward routes' arithmetic: bf16 products with fp32 sums, P and dS
# rounded to bf16 (csrc/flash_attention_bwd_sm90.cu); split-TF32 products,
# P and dS fp32 (csrc/flash_attention_bwd.cu)
# --------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _model_backward(q, k, v, o, do, lse, product, *, causal, window, q_offset=0,
                    round_p=lambda x: x, round_ds=lambda x: x):
    """A backward route's arithmetic (not its tile schedule), fp32 inside:
    every product is ``product(eq, x, y)``; P = exp(S·scale − lse) in fp32,
    ``round_p`` applied to it for dV = Pᵀ·dO; dS = P∘(dP − Δ), ``round_ds``
    applied to it for dQ = dS·K and dK = dSᵀ·Q, whose fp32 sums take the
    scale. Returns fp32 (dq, dk, dv)."""
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    g, scale = h // n_kv, d ** -0.5
    group = lambda t: t.reshape(b, n_kv, g, sq, d).float()  # noqa: E731
    qg, og, dog = group(q), group(o), group(do)
    kf, vf = k.float(), v.float()
    q_pos = q_offset + torch.arange(sq)
    k_pos = torch.arange(skv)
    keep = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        keep &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        keep &= q_pos[:, None] - k_pos[None, :] < window
    s = product("bkgsd,bkcd->bkgsc", qg, kf)
    p = torch.exp(s * scale - lse.reshape(b, n_kv, g, sq, 1)) * keep
    delta = (dog * og).sum(-1, keepdim=True)
    dv = product("bkgsc,bkgsd->bkcd", round_p(p), dog)
    ds = round_ds(p * (product("bkgsd,bkcd->bkgsc", dog, vf) - delta))
    dq = product("bkgsc,bkcd->bkgsd", ds, kf) * scale
    dk = product("bkgsc,bkgsd->bkcd", ds, qg) * scale
    return dq.reshape(b, h, sq, d), dk, dv


def _bf16_backward(q, k, v, o, do, lse, *, causal, window, q_offset=0):
    """A model of the bf16 backward route's arithmetic: every product takes
    bf16 operands and sums in fp32; P rounded to bf16 for dV, dS rounded to
    bf16 for dQ and dK, whose fp32 sums take the scale before they are
    rounded to bf16. Returns bf16 (dq, dk, dv)."""
    grads = _model_backward(q, k, v, o, do, lse, torch.einsum, causal=causal, window=window,
                            q_offset=q_offset, round_p=_bf16, round_ds=_bf16)
    return tuple(t.to(torch.bfloat16) for t in grads)


def _tf32_backward(q, k, v, o, do, lse, *, causal, window, q_offset=0, products=3):
    """A model of the fp32 backward route's arithmetic: every product as
    ``_tf32_product`` (three TF32 products of split operands, small terms
    first; with ``products=1``, hi·hi' alone), P and dS kept fp32 and split
    like any operand. Returns fp32 (dq, dk, dv)."""
    return _model_backward(q, k, v, o, do, lse,
                           lambda eq, x, y: _tf32_product(eq, x, y, products),
                           causal=causal, window=window, q_offset=q_offset)


def _tf32_backward_d256(q, k, v, o, do, lse, *, causal, window, q_offset=0):
    """A model of the fp32 route's order of sums at head_dim 256 (Cfg::SPLIT
    = 2): S, dP, P and dS as ``_tf32_backward`` (each score product over all
    of D in one sum, as the slab's two warps compute and swap them); dV and
    dK summed head by head of the group, then 16-query tile by tile, and dQ
    16-key tile by tile, each tile's product (three TF32 products) added
    into fp32 sums in that order, each 128-column half of an output (one
    warp's) apart. Returns fp32 (dq, dk, dv)."""
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    g, scale, tile, half = h // n_kv, d ** -0.5, 16, d // 2
    qg, og, dog = (t.reshape(b, n_kv, g, sq, d).float() for t in (q, o, do))
    kf, vf = k.float(), v.float()
    q_pos = q_offset + torch.arange(sq)
    k_pos = torch.arange(skv)
    keep = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        keep &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        keep &= q_pos[:, None] - k_pos[None, :] < window
    s = _tf32_product("bkgsd,bkcd->bkgsc", qg, kf, 3)
    p = torch.exp(s * scale - lse.reshape(b, n_kv, g, sq, 1)) * keep
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (_tf32_product("bkgsd,bkcd->bkgsc", dog, vf, 3) - delta)

    def tiled(eq, x, y, n, axis_x, axis_y):
        """sum over tiles of ``n`` rows (x's axis_x, y's axis_y) of x.y, a
        column half of y at a time."""
        halves = []
        for c0 in range(0, d, half):
            acc = None
            for r0 in range(0, n, tile):
                part = _tf32_product(eq, x.narrow(axis_x, r0, min(tile, n - r0)),
                                     y[..., c0:c0 + half].narrow(axis_y, r0, min(tile, n - r0)), 3)
                acc = part if acc is None else acc + part
            halves.append(acc)
        return torch.cat(halves, -1)

    dv = dk = None
    for j in range(g):  # the group's heads in order, each walking its query tiles
        pv = tiled("bksc,bksd->bkcd", p[:, :, j], dog[:, :, j], sq, 2, 2)
        pk = tiled("bksc,bksd->bkcd", ds[:, :, j], qg[:, :, j], sq, 2, 2)
        dv, dk = (pv, pk) if dv is None else (dv + pv, dk + pk)
    dq = tiled("bkgsc,bkcd->bkgsd", ds, kf, skv, 4, 2)
    return (dq * scale).reshape(b, h, sq, d), dk * scale, dv


# chip_smoke.BWD_CASES at a quarter of their lengths, windows and offsets
# (still ragged: 250, 75, 25), so the CPU runs them in seconds; head_dim 256
# (chip_smoke.BWD_CASES_D256, quartered too) on the fp32 route, modelled in
# its own order of sums
BWD_MODEL_CASES = [(b, h, kv, sq // 4, skv // 4, d, causal, window // 4, q_offset // 4)
                   for b, h, kv, sq, skv, d, causal, window, q_offset
                   in chip_smoke.BWD_CASES]
BWD_MODEL_CASES_D256 = [(b, h, kv, sq // 4, skv // 4, d, causal, window // 4, q_offset // 4)
                        for b, h, kv, sq, skv, d, causal, window, q_offset
                        in chip_smoke.BWD_CASES_D256]


def _bwd_inputs(b, h, kv, sq, skv, d, seed=5):
    """q, k, v and the output's gradient do as fp32 numpy arrays from a seed
    (a test may round them to bf16 for both packages)."""
    q_np, k_np, v_np = _qkv_np(b, h, kv, sq, d, skv, seed=seed)
    do_np = np.random.default_rng(seed + 1).standard_normal((b, h, sq, d), np.float32)
    return q_np, k_np, v_np, do_np


def _model_errors(model, dtype, case, against):
    """[(max |error|, max |wanted|)] of dq, dk and dv: ``model`` given the
    plain forward's o and lse in ``dtype``, against the plain backward (fp32
    inside) or against autodiff of the reference model's chunked twin
    (``repro/nn/attention.py:flash_attention``) in ``dtype``."""
    b, h, kv, sq, skv, d, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = _bwd_inputs(b, h, kv, sq, skv, d)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    got = model(q, k, v, o, do, lse, **kw)
    if against == "plain backward":
        want = [w.float().numpy() for w in ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)]
    else:
        jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrays)
        _, vjp = jax.vjp(lambda q_, k_, v_: jax_chunked_twin(q_, k_, v_, **kw), jq, jk, jv)
        want = [np.asarray(w, np.float32) for w in vjp(jdo)]
    return [(np.abs(g.float().numpy() - w).max(), np.abs(w).max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,q_offset", BWD_MODEL_CASES)
@pytest.mark.parametrize("against", ["plain backward", "jax.vjp of the reference twin"])
def test_bf16_backward_rounding_holds_bf16_tolerance(b, h, kv, sq, skv, d, causal, window,
                                                     q_offset, against):
    """The bf16 route's rounding points (P and dS to bf16 before their
    products) stay within half of chip_smoke's bf16 backward tolerance of
    the plain backward (fp32 inside), relative to each gradient's largest
    magnitude, and within 2e-2 of autodiff of the reference model's chunked
    twin in bf16 (``repro/nn/attention.py:flash_attention``): why the route
    may round them."""
    tol = chip_smoke.BWD_TOL[torch.bfloat16] / 2 if against == "plain backward" else 2e-2
    case = (b, h, kv, sq, skv, d, causal, window, q_offset)
    for name, (err, scale) in zip(("dq", "dk", "dv"),
                                  _model_errors(_bf16_backward, "bfloat16", case, against)):
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,q_offset",
                         BWD_MODEL_CASES + BWD_MODEL_CASES_D256)
@pytest.mark.parametrize("against", ["plain backward", "jax.vjp of the reference twin"])
def test_split_tf32_backward_holds_fp32_tolerance(b, h, kv, sq, skv, d, causal, window,
                                                  q_offset, against):
    """Three TF32 products per fp32 product in all five products, P and dS
    kept fp32 and split, stay within half of chip_smoke's fp32 backward
    tolerance of the plain backward, relative to each gradient's largest
    magnitude, and within 2e-5 of autodiff of the reference model's chunked
    twin in fp32: why the fp32 backward may run on the tensor cores. At
    head_dim 256 the model keeps the route's order of sums there
    (``_tf32_backward_d256``: tile by tile, each warp's half of the columns
    apart)."""
    tol = chip_smoke.BWD_TOL[torch.float32] / 2 if against == "plain backward" else 2e-5
    case = (b, h, kv, sq, skv, d, causal, window, q_offset)
    model = _tf32_backward_d256 if d == 256 else _tf32_backward
    for name, (err, scale) in zip(("dq", "dk", "dv"),
                                  _model_errors(model, "float32", case, against)):
        assert err <= tol * scale, (name, err, scale)


def test_one_tf32_product_misses_fp32_tolerance_in_the_backward():
    """hi·hi' alone in every product of the backward misses 2e-5 of
    max|grad| by far, at smollm's grouping: why the fp32 backward splits
    its operands."""
    one = lambda *args, **kw: _tf32_backward(*args, products=1, **kw)  # noqa: E731
    case = next(c for c in BWD_MODEL_CASES if c[1:3] == (15, 5))
    errors = _model_errors(one, "float32", case, "plain backward")
    assert max(err / scale for err, scale in errors) > 10 * 2e-5, errors


def test_plain_head_dim_256_mqa_window_matches_jax_ref():
    """recurrentgemma's attention: head_dim 256, 10 q heads on 1 kv head, a
    local window shorter than the sequence, ragged length."""
    kw = dict(causal=True, window=48)
    for dtype in DTYPES:
        (jq, jk, jv), (q, k, v) = _both(_qkv_np(2, 10, 1, 130, 256, seed=2), dtype)
        _close(ref.flash_attention_ref(q, k, v, **kw),
               jref.flash_attention_ref(jq, jk, jv, **kw), DTYPES[dtype][2])


# --------------------------------------------------------------------------
# RG-LRU scan
# --------------------------------------------------------------------------

def _scan_np(b, s, w, seed=0):
    """a in (0.79, 0.99) as the model's decays are, b ~ 0.1 N(0, 1), h0."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w)))) * 0.2 + 0.79
    return (a.astype(np.float32),
            (0.1 * rng.standard_normal((b, s, w))).astype(np.float32),
            rng.standard_normal((b, w)).astype(np.float32))


def _scan_both(b, s, w, dtype, with_h0, seed=0, exact=False):
    a, bb, h0 = _scan_np(b, s, w, seed)
    if exact:  # decays of exactly 0 and 1 on two lanes in three
        a[..., 0::3], a[..., 1::3] = 0.0, 1.0
    jdt, tdt, _ = DTYPES[dtype]
    jax_in = (jnp.asarray(a).astype(jdt), jnp.asarray(bb).astype(jdt),
              jnp.asarray(h0) if with_h0 else None)
    port_in = (torch.from_numpy(a).to(tdt), torch.from_numpy(bb).to(tdt),
               torch.from_numpy(h0) if with_h0 else None)
    return jax_in, port_in


def _scan_close(port, jax_out, dtype):
    (h, h_last), (jh, jh_last) = port, jax_out
    assert h.dtype == DTYPES[dtype][1] and h_last.dtype == torch.float32
    tol = RGLRU_TOL[dtype]
    _close(h, jh, tol)
    _close(h_last, jh_last, tol)


@pytest.mark.parametrize("b,s,w", RGLRU_CASES + RGLRU_RAGGED)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_rglru_scan_matches_jax_ref(b, s, w, dtype, with_h0):
    jax_in, port_in = _scan_both(b, s, w, dtype, with_h0)
    _scan_close(ref.rglru_scan_ref(*port_in), jref.rglru_scan_ref(*jax_in), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_rglru_scan_with_exact_zero_and_one_decays_matches_jax_ref(dtype, with_h0):
    jax_in, port_in = _scan_both(2, 300, 96, dtype, with_h0, seed=3, exact=True)
    _scan_close(ref.rglru_scan_ref(*port_in), jref.rglru_scan_ref(*jax_in), dtype)


@pytest.mark.parametrize("b,s,w", RGLRU_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_rglru_scan_matches_pallas_interpret(b, s, w, dtype, with_h0):
    jax_in, port_in = _scan_both(b, s, w, dtype, with_h0, seed=1)
    _scan_close(ref.rglru_scan_ref(*port_in),
                jax_rglru_scan(*jax_in, force="interpret"), dtype)


def test_rglru_dispatcher_cpu_uses_plain_and_counts_nothing():
    _, (a, b, h0) = _scan_both(2, 20, 16, "float32", True)
    before = ops.launch_counts()
    h, h_last = ops.rglru_scan(a, b, h0)
    assert ops.launch_counts() == before
    want = ref.rglru_scan_ref(a, b, h0)
    assert torch.equal(h, want[0]) and torch.equal(h_last, want[1])
    assert torch.equal(ops.rglru_scan(a, b, h0, force="ref")[0], h)


def test_rglru_dispatcher_force_kernel_on_cpu_raises():
    _, (a, b, _) = _scan_both(2, 20, 16, "float32", False)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_scan(a, b, force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.rglru_scan(a, b, force="interpret")
    assert ops.launch_counts() == before


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel is built and run there "
                    "(python3 chip_smoke.py covers the full case list)")
    both = list(DTYPES)
    cases = [(c, both) for c in FLASH_CASES + [(2, 4, 2, 200, 16, True, 0),
                                              (1, 4, 2, 1000, 128, True, 256)]]
    # bf16 (the wgmma route): the main paths' prefill shapes, a ragged MQA
    # window case at head_dim 256 and a head_dim 16 case
    cases += [(c, ["bfloat16"]) for c in [(8, 15, 5, 512, 64, True, 0),
                                          (8, 15, 5, 2048, 64, True, 0),
                                          (8, 10, 1, 512, 256, True, 2048),
                                          (1, 10, 1, 3072, 256, True, 2048),
                                          (2, 10, 1, 1000, 256, True, 256),
                                          (1, 4, 2, 300, 16, True, 0)]]
    for (b, h, kv, s, d, causal, window), dtypes in cases:
        for dtype in dtypes:
            _, tdt, tol = DTYPES[dtype]
            q, k, v = (torch.from_numpy(a).to("cuda", tdt)
                       for a in _qkv_np(b, h, kv, s, d))
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=tol, rtol=tol)


@pytest.mark.gpu
def test_rglru_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RG-LRU kernel is built and run there "
                    "(python3 chip_smoke.py covers the full case list)")
    cases = [(c, False) for c in RGLRU_CASES + RGLRU_RAGGED] + [((2, 300, 96), True)]
    for (b, s, w), exact in cases:
        for dtype in DTYPES:
            for with_h0 in (False, True):
                _, port_in = _scan_both(b, s, w, dtype, with_h0, exact=exact)
                a, bb, h0 = (None if t is None else t.cuda() for t in port_in)
                h, h_last = ops.rglru_scan(a, bb, h0, force="kernel")
                want, want_last = ref.rglru_scan_ref(a, bb, h0)
                again = ops.rglru_scan(a, bb, h0, force="kernel")
                torch.cuda.synchronize()
                tol = RGLRU_TOL[dtype]
                for got, exp in ((h, want), (h_last, want_last)):
                    np.testing.assert_allclose(got.float().cpu().numpy(),
                                               exp.float().cpu().numpy(),
                                               atol=tol, rtol=tol)
                # the kernel rounds as the plain version does, and no launch
                # depends on another's timing
                assert torch.equal(h, want) and torch.equal(h_last, want_last)
                assert torch.equal(again[0], h) and torch.equal(again[1], h_last)


# --------------------------------------------------------------------------
# gradients on the card: FlashAttentionFn and the backward kernel
# --------------------------------------------------------------------------

# (B, H, KV, Sq, Skv, D, causal, window, q_offset): GQA, MQA, MHA; causal,
# window, bidirectional; a suffix q; head_dim 16 to 256 (recurrentgemma's MQA
# with a window, ragged); smollm's shape
BWD_CARD_CASES = [(2, 4, 2, 256, 256, 64, True, 0, 0), (1, 8, 8, 128, 128, 128, True, 0, 0),
                  (2, 4, 1, 200, 200, 32, True, 64, 0), (1, 2, 2, 130, 130, 16, False, 0, 0),
                  (2, 6, 2, 100, 300, 64, True, 96, 200), (8, 15, 5, 512, 512, 64, True, 0, 0),
                  (2, 10, 1, 200, 200, 256, True, 96, 0)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels are built and run there "
                    "(python3 chip_smoke.py covers the full case list)")


def _grad_inputs(case, dtype, seed=0):
    b, h, kv, sq, skv, d = case[:6]
    q, k, v = (torch.from_numpy(a).to("cuda", DTYPES[dtype][1])
               for a in _qkv_np(b, h, kv, sq, d, skv, seed=seed))
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, h, sq, d), np.float32)).to("cuda", DTYPES[dtype][1])
    return q, k, v, do, dict(causal=case[6], window=case[7], q_offset=case[8])


@pytest.mark.gpu
def test_rglru_scan_gradients_on_card_equal_the_plain_backward():
    """With grad on, the scan's outputs carry RGLRUScanFn, whose backward is
    the reverse-scan kernel (csrc/rglru_bwd.cu): da, db and dh0 equal the
    plain backward (ref.rglru_scan_bwd_ref) bit for bit, on both load paths
    (TMA on 16-byte rows, the producer's own loads on W = 37), with and
    without h0 and h_last's gradient; one forward and one backward launch
    each; two backward launches give the same bits; bf16 raises."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, w in ((2, 100, 64), (2, 70, 37), (1, 1, 16)):
        for with_h0 in (False, True):
            a = (torch.rand((b, s, w), generator=gen, device="cuda") * 0.5 + 0.5)
            bb = torch.randn((b, s, w), generator=gen, device="cuda")
            h0 = torch.randn((b, w), generator=gen, device="cuda") if with_h0 else None
            g = torch.randn((b, s, w), generator=gen, device="cuda")
            gl = torch.randn((b, w), generator=gen, device="cuda")
            leaves = [t.clone().requires_grad_(True) for t in (a, bb)]
            if with_h0:
                leaves.append(h0.clone().requires_grad_(True))
            before = ops.launch_counts()
            h, h_last = ops.rglru_scan(*leaves)
            assert type(h.grad_fn).__name__ == "RGLRUScanFnBackward"
            got = torch.autograd.grad([h, h_last], leaves, [g, gl])
            after = ops.launch_counts()
            assert after["rglru_scan"] - before["rglru_scan"] == 1
            assert after["rglru_scan_bwd"] - before["rglru_scan_bwd"] == 1
            want_h, _ = ref.rglru_scan_ref(a, bb, h0)
            assert torch.equal(h.detach(), want_h)
            want = ref.rglru_scan_bwd_ref(a, want_h, g, h0, gl)
            again = rglru_scan_bwd_cuda(a, want_h, g, h0, gl)
            torch.cuda.synchronize()
            for x, y, z in zip(got, want, again):
                assert torch.equal(x, y) and torch.equal(x, z), (b, s, w, with_h0)
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan(a.to(torch.bfloat16).requires_grad_(True), bb.to(torch.bfloat16))


@pytest.mark.gpu
def test_tma_kernels_launch_from_a_thread_with_no_cuda_call_yet():
    """The kernels that encode TMA descriptors (the scan and its backward,
    the bf16 flash forward and backward) launch from a new thread, whose
    first CUDA call is theirs, as autograd's device thread's can be: the
    driver's encoder needs a current context there (csrc/sm90.cuh). Each
    gives the bits of the same launch on the main thread."""
    _card()
    from concurrent.futures import ThreadPoolExecutor

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((2, 100, 64), generator=gen, device="cuda") * 0.5 + 0.5
    b, g = (torch.randn((2, 100, 64), generator=gen, device="cuda") for _ in range(2))
    h, _ = rglru_scan_cuda(a, b)
    q, k, v = (torch.randn((1, 4, 128, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    launches = {"scan": lambda: rglru_scan_cuda(a, b),
                "scan backward": lambda: rglru_scan_bwd_cuda(a, h, g)[:2],
                "flash": lambda: (flash_attention_cuda(q, k, v),),
                "flash backward": lambda: flash_attention_bwd_cuda(q, k, v, o, q, lse)}
    for name, launch in launches.items():
        with ThreadPoolExecutor(max_workers=1) as pool:  # a new thread; its errors raise here
            out = pool.submit(lambda: (launch(), torch.cuda.synchronize())[0]).result(timeout=60)
        assert all(torch.equal(x, y) for x, y in zip(out, launch())), name


@pytest.mark.gpu
def test_flash_gradients_on_card_match_the_plain_backward():
    """With grad on, the kernel's output has FlashAttentionFn as its grad_fn
    and its gradients are the backward kernel's, of the route its dtype
    names (bf16: the wgmma kernels of flash_attention_bwd_sm90.cu, fp32:
    the split-TF32 mma.sync ones of flash_attention_bwd.cu, told apart by
    the profiler's kernel names), within 2e-5 (fp32) or 2e-2 (bf16) of the
    plain backward relative to the gradients' magnitude; two backward
    launches give the same bits.

    The profiler (Kineto) drops the first GPU records of a session as out
    of its capture window (its log: "Record counts: Out-of-range = 1" or 2),
    so the session opens with one synchronized CUDA operation of its own,
    whose record takes that drop; the backward's three kernels come after
    it, and each must be seen exactly once."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    for case in BWD_CARD_CASES:
        for dtype in DTYPES:
            q, k, v, do, kw = _grad_inputs(case, dtype)
            tol = DTYPES[dtype][2]
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = ops.launch_counts()
            o = ops.flash_attention(*leaves, **kw)
            assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device="cuda").sum().item()  # the session's first records
                grads = torch.autograd.grad(o, leaves, do)
                torch.cuda.synchronize()
            seen = {(e.name, e.time_range.start) for e in prof.events() if "flash_bwd" in e.name
                    and e.device_type == torch.autograd.DeviceType.CUDA}
            kernels = {name for name, _ in seen}
            route = [n for n in kernels if "_sm90" in n]
            assert len(kernels) == 3, (case, dtype, kernels)  # the Δ pass, dK/dV, dQ
            assert len(seen) == 3, (case, dtype, seen)  # each once
            assert len(route) == (3 if dtype == "bfloat16" else 0), (case, dtype, kernels)
            after = ops.launch_counts()
            assert after["flash_attention"] - before["flash_attention"] == 1
            assert after["flash_attention_bwd"] - before["flash_attention_bwd"] == 1
            o2, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, o2, do, lse, **kw)
            again = flash_attention_bwd_cuda(q, k, v, o2, do, lse, **kw)
            torch.cuda.synchronize()
            assert torch.equal(o.detach(), o2)
            for got, exp, rep in zip(grads, want, again):
                scale = exp.float().abs().max().item()
                err = (got.float() - exp.float()).abs().max().item()
                assert err <= tol * max(scale, 1.0), (case, dtype, err, scale)
                assert torch.equal(got, rep), (case, dtype)


@pytest.mark.gpu
def test_flash_bwd_misaligned_bf16_do_raises_and_launches_nothing():
    """The bf16 route's TMA loads need o and do 16-byte aligned: a
    contiguous view that starts 2 bytes past an aligned pointer raises
    ValueError before any launch, as q, k and v do in the forward."""
    _card()
    q, k, v, do, kw = _grad_inputs(BWD_CARD_CASES[0], "bfloat16")
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    for name in ("do", "o"):
        shifted = torch.empty(do.numel() + 1, dtype=do.dtype, device=do.device)[1:]
        shifted = shifted.view(do.shape).copy_(do if name == "do" else o)
        args = {"o": o, "do": do, name: shifted}
        before = ops.launch_counts()["flash_attention_bwd"]
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_bwd_cuda(q, k, v, args["o"], args["do"], lse, **kw)
        assert ops.launch_counts()["flash_attention_bwd"] == before


@pytest.mark.gpu
def test_flash_bwd_shared_memory_fits_a_block_at_every_head_dim():
    """Each backward route's larger tile kernel fits the 227 KB (232,448
    bytes) a block may use, at every head dim the backward takes."""
    _card()
    for dtype in BWD_ROUTES:
        for d in HEAD_DIMS:
            assert 0 < bwd_smem_bytes(d, dtype) <= 232_448, (dtype, d)


@pytest.mark.gpu
def test_flash_lse_on_card_matches_plain():
    _card()
    for case in BWD_CARD_CASES:
        for dtype in DTYPES:
            q, k, v, _, kw = _grad_inputs(case, dtype, seed=2)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            _, want = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
            assert torch.equal(o, flash_attention_cuda(q, k, v, **kw))  # lse changes no bit of o
            np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_checkpoint_recompute_reproduces_the_forward_on_card(monkeypatch):
    """Under non-reentrant torch.utils.checkpoint the backward recomputes the
    forward kernel (a second forward launch) and gets the same o and lse
    (checkpoint itself checks only shapes): the gradients equal those
    without checkpointing bit for bit."""
    _card()
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import flash_attention as fa

    q, k, v, do, kw = _grad_inputs(BWD_CARD_CASES[0], "bfloat16", seed=3)
    seen, forward = [], fa.flash_attention_cuda

    def recording(*args, **kwargs):  # FlashAttentionFn's forward, recorded
        out = forward(*args, **kwargs)
        seen.append(tuple(t.detach().clone() for t in out))
        return out

    # the wrapper counts its launches under the module's name, so while it
    # stands in for the wrapper the count lands on it
    recording.launches = 0
    monkeypatch.setattr(fa, "flash_attention_cuda", recording)
    attend = lambda q, k, v: ops.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attend(*plain), plain, do)
    remat = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = recording.launches
    got = torch.autograd.grad(checkpoint(attend, *remat, use_reentrant=False), remat, do)
    assert recording.launches - before == 2
    assert len(seen) == 3  # plain, checkpointed, its recompute
    for first, again in ((seen[1], seen[2]), (seen[0], seen[1])):
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # head_dim 256 (recurrentgemma's): both routes have a backward; the fp32
    # one's gradients within 2e-5 of the plain backward's largest magnitude
    d256 = [torch.randn((1, 2, 8, 256), device="cuda").to(torch.bfloat16).requires_grad_(True)
            for _ in range(3)]
    ops.flash_attention(*d256).float().sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad.float()).all()) for t in d256)
    q, k, v = (torch.randn((1, 2, 8, 256), device="cuda") for _ in range(3))
    d256 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()["flash_attention_bwd"]
    ops.flash_attention(*d256).sum().backward()
    assert ops.launch_counts()["flash_attention_bwd"] - before == 1
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    for t, want in zip(d256, ref.flash_attention_bwd_ref(q, k, v, o, torch.ones_like(o), lse)):
        assert (t.grad - want).abs().max().item() <= 2e-5 * max(want.abs().max().item(), 1.0)
