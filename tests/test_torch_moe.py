"""The port's MoE FFN (repro_torch.nn.moe) against the JAX package's
(repro.nn.moe), on the CPU.

Router, expert weights and inputs are seeded numpy arrays loaded into both
packages. The dispatch map must be exactly the reference's (the stable
sort decides which rows overflow a capacity); the FFN's output is held to
2e-5 in fp32 and 2e-2 in bf16 (the port sums a token's k expert outputs in
k order, the reference scatter-adds them in expert order), with and without
rows dropped at capacity, at a prefill's and a decode's token count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe

from repro_torch.nn import moe

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# (T, d, E, k, f): granite tiny's experts at a prefill's tokens (2 x 16) and
# at a decode step's (B = 8), qwen3-moe tiny's, and one wider
SHAPES = [(32, 64, 5, 2, 64), (8, 64, 5, 2, 64), (48, 64, 8, 2, 96), (64, 32, 40, 8, 16)]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _params(d, e, f, seed=0):
    """Router (fp32, std 1/sqrt(d)) and expert weights (std 1/sqrt(fan-in)),
    fp32 numpy."""
    rng = _rng(seed)
    return {"router": rng.standard_normal((d, e), np.float32) / np.sqrt(d),
            "up": rng.standard_normal((e, d, f), np.float32) / np.sqrt(d),
            "gate": rng.standard_normal((e, d, f), np.float32) / np.sqrt(d),
            "down": rng.standard_normal((e, f, d), np.float32) / np.sqrt(f)}


def _both(p_np, dtype):
    """The same params in each package: router fp32, experts in ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()).to(torch.float32 if k == "router" else tdt)
          for k, v in p_np.items()}
    return jp, tp


def _x(t, d, dtype, seed=1):
    x = _rng(seed).standard_normal((t, d), np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _near_ties(probs, k):
    """Tokens whose k-th and (k+1)-th router probabilities lie within 1e-6:
    where fp32 sums in another order may pick another expert."""
    top = np.sort(probs, axis=-1)[:, ::-1]
    return int((top[:, k - 1] - top[:, k] < 1e-6).sum()) if probs.shape[-1] > k else 0


@pytest.mark.parametrize("t,k,e,factor", [
    (32, 2, 5, 1.25),     # granite tiny prefill: ceil(16)
    (8, 2, 5, 1.25),      # decode B8: 4, the floor
    (4096, 8, 40, 1.25),  # granite B8 S512: 1024
    (8, 8, 40, 1.25),     # granite decode B8: ceil(2) -> the floor 4
    (1, 2, 8, 1.25),      # one token: the floor 4 capped at T*k = 2
    (2, 1, 64, 1.0),      # capped at T*k = 2
    (100, 2, 8, 0.5),     # a factor under 1
    (48, 2, 8, 1.0),      # exact: 12
])
def test_capacity_matches_reference(t, k, e, factor):
    assert moe.capacity(t, k, e, factor) == jmoe.capacity(t, k, e, factor)


@pytest.mark.parametrize("t,d,e,k,f", SHAPES)
def test_router_topk_matches_reference(t, d, e, k, f):
    jp, tp = _both(_params(d, e, f), "float32")
    jx, x = _x(t, d, "float32")
    jw, jidx, jaux = jmoe.router_topk(jp["router"], jx, k)
    w, idx, aux = moe.router_topk(tp["router"], x, k)
    probs = np.asarray(jax.nn.softmax(jx @ jp["router"], axis=-1))
    ties = _near_ties(probs, k)
    print(f"T{t} E{e} k{k}: tokens within 1e-6 of a tie: {ties}")
    assert ties == 0
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    assert w.dtype == torch.float32 and aux.dtype == torch.float32 and aux.dim() == 0


@pytest.mark.parametrize("t,k,e,cap", [
    (32, 2, 5, 16),    # no drops
    (32, 2, 5, 4),     # drops
    (8, 2, 5, 4),      # decode's capacity
    (64, 8, 40, 16),   # granite's routing width
    (48, 2, 8, 6),     # drops at 8 experts
    (5, 3, 4, 1),      # capacity 1
])
def test_dispatch_indices_equal_reference(t, k, e, cap):
    """At all the experts (the reference's e_start 0, e_local E; subsets
    below)."""
    rng = _rng(t + cap)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    jsrc, jsizes = jmoe._dispatch_indices(jnp.asarray(idx), e, cap, 0, e)
    src, sizes = moe._dispatch_indices(torch.from_numpy(idx).long(), e, cap)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))


@pytest.mark.parametrize("t,k,e,cap,e_start,e_local", [
    (32, 2, 8, 16, 0, 4),    # the first of two expert-parallel shards
    (32, 2, 8, 4, 4, 4),     # the second, with drops
    (64, 8, 40, 16, 30, 10),  # the last of four at granite's width
    (5, 3, 4, 1, 2, 1),      # one expert, capacity 1
])
def test_dispatch_indices_of_an_expert_subset_equal_reference(t, k, e, cap, e_start, e_local):
    """The expert-parallel branch's map: the slots of experts [e_start,
    e_start + e_local) only, index for index."""
    rng = _rng(t + cap + e_start)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    jsrc, jsizes = jmoe._dispatch_indices(jnp.asarray(idx), e, cap, e_start, e_local)
    src, sizes = moe._dispatch_indices(torch.from_numpy(idx).long(), e, cap, e_start, e_local)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("shard", [0, 1])
def test_moe_ffn_local_of_an_expert_subset_matches_reference(shard, factor):
    """One of two expert-parallel shards of qwen3-moe tiny's 8 experts: the
    local experts' contributions only, fp32, as the reference's
    ``moe_ffn_local(e_start=, e_local=)`` gives them."""
    t, d, e, k, f = 48, 64, 8, 2, 96
    p = _params(d, e, f)
    lo, hi = 4 * shard, 4 * shard + 4
    p = dict(p, **{n: p[n][lo:hi] for n in ("up", "gate", "down")})
    jp, tp = _both(p, "float32")
    jx, x = _x(t, d, "float32")
    jy, jaux = jmoe.moe_ffn_local(jp, jx, top_k=k, capacity_factor=factor, e_start=lo,
                                  e_local=4)
    y, aux = moe.moe_ffn_local(tp, x, top_k=k, capacity_factor=factor, e_start=lo, e_local=4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,d,e,k,f", SHAPES)
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_ffn_local_matches_reference(t, d, e, k, f, factor, dtype):
    """factor 0.5 forces drops at every shape but decode's, whose capacity
    is the floor 4; 1.25 drops where an expert draws more than its share."""
    jp, tp = _both(_params(d, e, f), dtype)
    jx, x = _x(t, d, dtype)
    jy, jaux = jmoe.moe_ffn_local(jp, jx, top_k=k, capacity_factor=factor)
    y, aux = moe.moe_ffn_local(tp, x, top_k=k, capacity_factor=factor)
    tol = DTYPES[dtype][2]
    assert y.dtype == DTYPES[dtype][1] and y.shape == (t, d)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    # dropped rows: the reference's and the port's count agree
    cap = moe.capacity(t, k, e, factor)
    _, jidx, _ = jmoe.router_topk(jp["router"], jx, k)
    counts = np.bincount(np.asarray(jidx).reshape(-1), minlength=e)
    dropped = int(np.clip(counts - cap, 0, None).sum())
    print(f"T{t} E{e} k{k} factor {factor} {dtype}: capacity {cap}, rows dropped {dropped}")
    if factor == 0.5 and t > 8:
        assert dropped > 0


def test_moe_ffn_local_zero_weight_for_a_dropped_row():
    """A token whose every choice is dropped gets exactly zero."""
    d, e, f = 16, 2, 8
    p = _params(d, e, f)
    p["router"][:] = 0.0
    p["router"][0, 0] = 50.0  # every token prefers expert 0
    _, tp = _both(p, "float32")
    x = torch.ones((12, d))
    y, _ = moe.moe_ffn_local(tp, x, top_k=1, capacity_factor=1.0)
    cap = moe.capacity(12, 1, e, 1.0)  # 6 rows of expert 0 kept
    assert torch.all(y[cap:] == 0) and torch.all(y[:cap] != 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_ffn_local_two_calls_bit_equal(dtype):
    _, tp = _both(_params(64, 40, 16), dtype)
    _, x = _x(64, 64, dtype)
    a, aux_a = moe.moe_ffn_local(tp, x, top_k=8, capacity_factor=1.25)
    b, aux_b = moe.moe_ffn_local(tp, x, top_k=8, capacity_factor=1.25)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_ffn_batched_matches_reference():
    """(B, S, d) through the reference's no-mesh path: the B·S tokens
    routed as one stream."""
    jp, tp = _both(_params(64, 5, 64), "float32")
    x = _rng(3).standard_normal((2, 12, 64), np.float32)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=2)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), top_k=2)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)


def test_def_moe_matches_reference():
    from repro.nn import params as jprm
    from repro_torch.utils.trees import tree_flatten_with_paths
    want = {p: (tuple(v.shape), v.init, v.dtype) for p, v in
            jax.tree_util.tree_flatten_with_path(
                jmoe.def_moe(1536, 40, 512, 8),
                is_leaf=lambda x: isinstance(x, jprm.ParamDef))[0]
            for p in [jax.tree_util.keystr(p, simple=True, separator="/")]}
    got = {p: (tuple(v.shape), v.init, v.dtype)
           for p, v in tree_flatten_with_paths(moe.def_moe(1536, 40, 512, 8))}
    assert got == want
    assert got["router"] == ((1536, 40), "scaled_fan_in", "float32")
