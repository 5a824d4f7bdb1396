"""Hopper flash attention, bound with ctypes. The forward takes one of two
routes:

- bf16 takes ``csrc/flash_attention_sm90.cu``: wgmma on the tensor cores,
  TMA loads into swizzled shared memory, a two-stage K/V ring on mbarriers,
  a persistent grid walking (batch, head, query tile) work tiles heaviest
  first (``fwd_tile_order`` is its twin);
- fp32 takes ``csrc/flash_attention.cu``: mma.sync on the tensor cores, each
  fp32 product as three TF32 products of split operands (hi = tf32(x),
  lo = x - hi), which hold fp32's tolerance where one TF32 product does
  not; a two-stage cp.async ring of K/V tiles.

Both replace the TPU kernel ``repro/kernels/flash_attention.py:_flash_kernel``
and compute what that kernel does (GQA; causal, local-window or
bidirectional masks; absolute ``q_offset``; fp32 online softmax), at head_dim
16, 32, 64, 128 and 256, and any sequence lengths. Each source's header says
what bounds it on the card and what its design does about it. Their plain
version is ``repro_torch.kernels.ref.flash_attention_ref``.

The backward has no TPU counterpart: the JAX package trains through
autodiff of its jnp twin. It takes one of two routes too (``BWD_ROUTES``),
at the forward's head dims:

- bf16 takes ``csrc/flash_attention_bwd_sm90.cu`` (head_dim 16 to 256): its
  products on wgmma, Q/K/V/dO tiles loaded by TMA into swizzled shared
  memory, a ring of streamed tiles on mbarriers; at head_dim 16 to 64
  (``FUSED_DQ_HEAD_DIMS``) the dK/dV kernel also computes dQ from the dS it
  holds, five products a (query, key) pair, and sums it across key tiles in
  a fixed order; at 128 and 256 a dQ kernel recomputes S and dP, seven
  products (nine at 256, where two consumer warpgroups split dK and dV by
  columns);
- fp32 takes ``csrc/flash_attention_bwd.cu`` (head_dim 16 to 256): mma.sync
  on the tensor cores, each fp32 product as three TF32 products of split operands (P and
  dS kept fp32), a two-stage cp.async ring of streamed tiles; at head_dim
  256 two warps share each 16-row slab, splitting dK, dV and dQ by columns;
  the forward's TF32 helpers are shared through ``csrc/tf32.cuh``.

Both are deterministic and recompute the probabilities from the forward's
fp32 logsumexp, which the forward writes when asked (``return_lse``): the
FlashAttention-2 split into a Δ pass, a dK/dV kernel and a dQ kernel, no
atomics; on the fused route a Δ pass, the dK/dV kernel with dQ, whose
parts each query tile adds into an fp32 workspace in a fixed key-tile
order, one turn counter a (batch, q head, query tile) (``key_tile_order``,
``dq_run`` and ``dq_turn`` are the order's twins), and a pass that scales
and rounds the sums. ``FlashAttentionFn`` binds forward and backward for
autograd; the backward's plain version is ``ref.flash_attention_bwd_ref``.

The dK/dV kernel walks, for each (batch, kv head, key tile of 64 keys), the
G query heads of the group and then the query tiles that see the tile
(``dkdv_walks``). Under GQA and MQA, and under a causal mask for key tile 0,
that walk can be several times an even share of the launch's steps over the
card's slots (its SMs times the kernel's blocks a SM), and the card idles
behind the heaviest blocks. ``bwd_split`` cuts each walk into P slices, one
block each, whose fp32 parts a fourth kernel adds in slice order; P = 1
(no parts, the unsplit kernel's bits) wherever the heaviest walk is within
``SPLIT_AT`` even shares. A caller may force P (``split``); an invalid P
raises.

A library is built at its first launch (``_build``). The wrappers check
what the kernels take (among it a 16-byte-aligned pointer, which TMA
needs) and raise on anything else; they never fall back to the other route
or to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, cost

HEAD_DIMS = (16, 32, 64, 128, 256)  # the forward's and, on both routes, the backward's
# dtype -> (source in csrc/, which is also its C entry points' prefix; route name)
ROUTES = {torch.bfloat16: ("flash_attention_sm90", "cuda-wgmma"),
          torch.float32: ("flash_attention", "cuda-fp32")}
BWD_ROUTES = {torch.bfloat16: ("flash_attention_bwd_sm90", "cuda-wgmma"),
              torch.float32: ("flash_attention_bwd", "cuda-fp32")}
# The dK/dV walk: keys a block (both routes' BR / BM), and queries a step
# (the fp32 route's Cfg::BS, the bf16 route's Cfg::KV_BN)
BWD_KEYS = 64
# The split's threshold: the heaviest walk in even shares (its steps over
# all steps / slots) up to which P stays 1. Below about two the balance can
# gain at most half of the dK/dV kernel, which the parts' traffic and the
# reduction take back: at smollm's train shape (1.47 even shares) P = 2 made
# the bf16 backward 11% slower and the fp32 one 8% faster, at whisper's
# decoder's (1.38) the bf16 one 46% slower (benchmarks/
# torch_flash_bwd_variants.py, PERF.md); MQA's and GQA 8:1's walks are 3.7.
SPLIT_AT = 2.0
# The fewest steps a planned slice walks: a slice's block also loads its K
# and V tiles and stores its parts (each as many bytes as one to four steps
# stream), so on a launch smaller than the card, where an even share is a
# few steps or less, slices stay this long.
MIN_SLICE = 16
# What the meta route plans for, having no card: one H100's SMs
# (``meta_slots``). The card route asks the card
# (``flash_attention_bwd*_slots``); chip_smoke.py checks the two agree.
H100_SMS = 132
# The bf16 backward's head dims whose dK/dV kernel also computes dQ: the
# source's FUSED_DQ_HEAD_DIMS, which a test holds this twin to. There the
# call takes an fp32 dQ workspace (B, H, Sq, D) and int32 turn counters (B,
# H, ceil(Sq / BWD_KEYS)) beside its other scratch.
FUSED_DQ_HEAD_DIMS = (16, 32, 64)
# The fused route orders its dQ sums by groups of a wave's key tiles up to
# this many waves a launch, ascending key tiles past it (``dq_group``). On
# the card (benchmarks/torch_flash_bwd_variants.py, PERF.md):
# grouped, smollm's S512 (1.2 waves) 0.0715 ms against 0.0803 ascending and
# whisper's decoder (1.3) 0.0308 against 0.0365, where ascending holds
# every key tile of a causal wave to the heaviest one's pace; ascending,
# smollm's S2048 (4.8 waves, a 63 MB fp32 workspace) 0.60 against 0.72
# grouped, whose concurrent blocks add into query tiles spread past L2.
DQ_GROUP_WAVES = 2


@functools.cache
def _fwd(dtype):
    """The route's C entry point, typed; its library is built at the first call."""
    source, _ = ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of ``dtype``'s route at
    ``head_dim``, from the source."""
    source, _ = ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(head_dim)


def fwd_query_rows(head_dim: int) -> int:
    """Query rows of one work tile of the bf16 forward (the source's
    ``Cfg::BQ``): one consumer warpgroup of 64 rows up to head_dim 64, two
    above."""
    return 64 if head_dim <= 64 else 128


def fwd_meta_slots(head_dim: int) -> int:
    """The bf16 forward's blocks a launch holds at once on one H100: its SMs
    times the blocks a SM the source's launch bounds set (two of one
    consumer up to head_dim 64, one of two above)."""
    return H100_SMS * (2 if head_dim <= 64 else 1)


@functools.cache
def fwd_card_slots(head_dim: int, index: int) -> int:
    """The bf16 forward's persistent blocks on card ``index``: its SMs times
    the kernel's blocks a SM, as the CUDA occupancy calculator gives them."""
    source, _ = ROUTES[torch.bfloat16]
    fn = getattr(_build.load(source), f"{source}_slots")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    with torch.cuda.device(index):
        slots = fn(head_dim)
    if slots <= 0:
        raise RuntimeError(f"{source}_slots({head_dim}) failed: {slots}")
    return slots


def fwd_tile_order(b: int, h: int, sq: int, head_dim: int, slots: int) -> list:
    """The bf16 forward's walk, the kernel's ``work_index`` and
    ``work_tile`` twin: for each block of its grid (``min(tiles, slots)``),
    the (batch, q head, query tile) work tiles it takes, in order. Work tile
    w is query tile ``q_tiles - 1 - w // (b h)`` (the last, heaviest under a
    causal mask, first), batch ``w % (b h) // h``, head ``w % h`` (a KV
    group's heads side by side). The blocks take them in rounds of ``grid``,
    back and forth: in round k block i takes w = k grid + i for even k and
    k grid + grid - 1 - i for odd k."""
    q_tiles = -(-sq // fwd_query_rows(head_dim))
    n = b * h * q_tiles
    grid = min(n, slots)
    order = [[] for _ in range(grid)]
    for k in range(-(-n // grid)):
        for i in range(grid):
            w = k * grid + (grid - 1 - i if k % 2 else i)
            if w < n:
                order[i].append((w % (b * h) // h, w % h, q_tiles - 1 - w // (b * h)))
    return order


def _check(q, k, v, device="cuda"):
    """What the kernels take; ``device`` "meta" checks a shape function's
    inputs (which lie on no card and have no storage)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != device:
            raise ValueError(f"flash_attention_{device}: {name} is on {t.device}, the "
                             + ("kernel takes CUDA" if device == "cuda" else
                                "shape function takes meta") + " tensors only")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v differ in dtype or device")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} starts at a pointer that is "
                             "not 16-byte aligned (TMA needs it); pass a fresh contiguous copy")
    if q.dtype not in ROUTES:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not supported "
                         f"(takes {list(ROUTES)})")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {d} not in {HEAD_DIMS}")
    if h % k.shape[1]:
        raise ValueError(f"flash_attention_cuda: {h} q heads not a multiple of "
                         f"{k.shape[1]} kv heads")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention_cuda: empty inputs")


def flash_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                         return_lse=False):
    """q: (B, H, Sq, D); k/v: (B, KV, Skv, D), CUDA, contiguous, 16-byte
    aligned, one dtype: bf16 takes the wgmma route, fp32 the split-TF32 one.
    Returns (B, H, Sq, D) in q's dtype, on q's device and current stream;
    with ``return_lse`` also each row's fp32 logsumexp (B, H, Sq)."""
    _check(q, k, v)
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_cuda: window and q_offset must be >= 0")
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = _fwd(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            None if lse is None else lse.data_ptr(),
                            b, h, n_kv, sq, skv, d, int(bool(causal)), int(window),
                            int(q_offset), float(d ** -0.5),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{ROUTES[q.dtype][0]}_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    cost.report_attention(q, k, v, (o, lse), causal=causal, window=window, q_offset=q_offset)
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0  # kernel launches since the last reset


def flash_attention_meta(q, k, v, *, causal=True, window=0, q_offset=0,
                         return_lse=False):
    """The forward kernel's shape function on meta tensors (the dry-run's):
    it checks what ``flash_attention_cuda`` checks, allocates what it
    allocates (o, and the fp32 lse when asked), reports the kernel's cost
    (``cost``) and launches nothing: no (B, H, Sq, Skv) scores, as the
    kernel keeps none."""
    _check(q, k, v, "meta")
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_meta: window and q_offset must be >= 0")
    b, h, sq, _ = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    cost.report_attention(q, k, v, (o, lse), causal=causal, window=window, q_offset=q_offset)
    return (o, lse) if return_lse else o


def bwd_argtypes(dtype) -> list:
    """The ctypes of the backward route's C entry point: ten pointers, nine
    ints, the scale, the split, the parts' pointer, on the bf16 route the dQ
    workspace's and the counters' pointers and the dQ order's group, and the
    stream."""
    fused = [ctypes.c_void_p] * 2 + [ctypes.c_int] if dtype == torch.bfloat16 else []
    return ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p] + fused
            + [ctypes.c_void_p])


@functools.cache
def _bwd(dtype):
    """The backward route's C entry point, typed; its library is built at
    the first call."""
    source, _ = BWD_ROUTES[dtype]
    fn = getattr(_build.load(source), source)
    fn.argtypes = bwd_argtypes(dtype)
    fn.restype = ctypes.c_int
    return fn


def bwd_fuses_dq(d: int, dtype: torch.dtype) -> bool:
    """Whether ``dtype``'s backward at head_dim ``d`` computes dQ in its
    dK/dV kernel (the bf16 route at FUSED_DQ_HEAD_DIMS)."""
    return dtype == torch.bfloat16 and d in FUSED_DQ_HEAD_DIMS


def dq_group(b: int, kv: int, split: int, k_tiles: int, slots: int) -> int:
    """Key tiles a group of the fused route's dQ order (``key_tile_order``)
    on a launch of B·KV·P blocks a key tile over ``slots``: as many as one
    wave holds, at least one, where the launch is within DQ_GROUP_WAVES
    waves; else 1, ascending order. Within a group the order is the walks'
    natural one (a causal walk reaches a query tile sooner the later its
    key tile), so no block waits on a heavier one's pace; across groups
    the heaviest go first."""
    per_tile = b * kv * split
    if per_tile * k_tiles > DQ_GROUP_WAVES * slots:
        return 1
    return max(1, slots // per_tile)


def key_tile_order(k_tiles: int, group: int) -> list:
    """The dK/dV grid's key tiles in launch order, the source's
    key_tile_at: groups of ``group`` tiles ascending, each group's tiles
    descending (group 1: 0, 1, 2, ...)."""
    return [min(k_tiles, g0 + group) - 1 - i for g0 in range(0, k_tiles, group)
            for i in range(min(group, k_tiles - g0))]


def dq_run(t, bs, k_tiles, sq, skv, causal, window, q_offset) -> tuple[int, int]:
    """The source's dq_run: the key tiles whose walks hold query tile t
    (``bs`` queries a tile) are one run, (first, last), none if last <
    first: from the first whose last key is within the window of the
    tile's first query, to the last whose first key is before the tile's
    end."""
    x = t * bs + q_offset - window
    first = 0 if window <= 0 or x < BWD_KEYS - 1 else (x - BWD_KEYS + 1) // BWD_KEYS + 1
    if first >= k_tiles - 1 and window > 0 and skv - 1 <= x:
        first = k_tiles
    last = (min(k_tiles, (min(sq, (t + 1) * bs) + q_offset + BWD_KEYS - 1) // BWD_KEYS) - 1
            if causal else k_tiles - 1)
    return first, last


def dq_turn(n, run, k_tiles, group) -> int:
    """The source's dq_turn: key tile n's turn in the sum of a query
    tile's dQ whose run is ``run`` (``dq_run``), the number of the run's key
    tiles that come before n in ``key_tile_order``."""
    first, last = run
    g0 = n // group * group
    hi = min(k_tiles, g0 + group)
    return max(0, min(last, g0 - 1) - first + 1) + max(0, min(last, hi - 1) - n)


def bwd_query_tile(d: int, dtype: torch.dtype) -> int:
    """Queries a step of ``dtype``'s dK/dV walk streams at head_dim ``d``."""
    if dtype == torch.float32:
        return 32 if d <= 64 else 16
    return 64 if d <= 64 else 32


def meta_slots(d: int, dtype: torch.dtype) -> int:
    """The dK/dV kernel's slots the meta route plans for: one H100's SMs
    times the blocks a SM that ``dtype``'s kernel at head_dim ``d`` takes
    there, as its source's launch bounds set them: one at 256, where a
    block takes 132 KB (bf16) or 208 KB (fp32) of shared memory; three on
    the fp32 route at 16; two elsewhere, where registers allow two."""
    per_sm = 1 if d == 256 else 3 if dtype == torch.float32 and d == 16 else 2
    return H100_SMS * per_sm


@functools.cache
def card_slots(dtype: torch.dtype, d: int, index: int) -> int:
    """The dK/dV kernel's slots on card ``index``: its SMs times the
    kernel's blocks a SM, as the CUDA occupancy calculator gives them."""
    source, _ = BWD_ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_slots")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    with torch.cuda.device(index):
        slots = fn(d)
    if slots <= 0:
        raise RuntimeError(f"{source}_slots({d}) failed: {slots}")
    return slots


@functools.cache
def dkdv_walks(h, kv, sq, skv, d, dtype, causal, window, q_offset) -> tuple[int, ...]:
    """Steps of each key tile's dK/dV walk, key tile 0 first: the G query
    heads of the group times the query tiles of ``bwd_query_tile`` rows that
    see any key of the tile (the kernels' t_lo, t_hi)."""
    bs, steps = bwd_query_tile(d, dtype), []
    for n0 in range(0, skv, BWD_KEYS):
        n_last = min(n0 + BWD_KEYS, skv) - 1
        m_lo = max(0, n0 - q_offset) if causal else 0
        m_hi = min(sq, n_last + window - q_offset) if window > 0 else sq
        t_lo = m_lo // bs
        t_hi = -(-m_hi // bs) if m_hi > m_lo else t_lo
        steps.append(h // kv * (t_hi - t_lo))
    return tuple(steps)


@functools.cache
def bwd_split(b, h, kv, sq, skv, d, dtype, causal, window, q_offset, slots) -> int:
    """The dK/dV walk's split P for these shapes, masks and ``slots``: 1
    where the heaviest key tile's walk is within SPLIT_AT even shares (all
    steps of the launch over the slots), else the least P whose slices of
    the heaviest walk are each within one even share, or within MIN_SLICE
    steps where an even share is shorter."""
    steps = dkdv_walks(h, kv, sq, skv, d, dtype, causal, window, q_offset)
    heaviest, even = max(steps), b * kv * sum(steps) / slots
    if heaviest <= SPLIT_AT * even:
        return 1
    return math.ceil(heaviest / max(even, MIN_SLICE))


def bwd_plan(q, k, *, causal=True, window=0, q_offset=0, split=None) -> int:
    """The split P the backward of q (B, H, Sq, D) against k (B, KV, Skv, D)
    runs at: ``bwd_split`` with the slots of q's card (a meta q: an
    H100's), or ``split`` if given, which must be an int from 1 to the
    heaviest walk's steps (1 where no query sees a key), with the key tiles
    times P within the grid's 65535."""
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    args = (h, n_kv, sq, skv, d, q.dtype, bool(causal), int(window), int(q_offset))
    if split is None:
        slots = card_slots(q.dtype, d, q.device.index) if q.is_cuda else meta_slots(d, q.dtype)
        return bwd_split(b, *args, slots)
    steps = dkdv_walks(*args)
    if isinstance(split, bool) or not isinstance(split, int) or \
            not 1 <= split <= max(1, *steps) or len(steps) * split > 65535:
        raise ValueError(f"flash_attention_bwd: split {split!r} must be an int from 1 to the "
                         f"heaviest key tile's {max(steps)} steps, with {len(steps)} key tiles "
                         "times it within 65535")
    return split


def bwd_smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the larger of the two tile kernels' blocks
    of ``dtype``'s backward route at ``head_dim``, from the source."""
    source, _ = BWD_ROUTES[dtype]
    fn = getattr(_build.load(source), f"{source}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(head_dim)


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal=True, window=0,
                             q_offset=0, split=None):
    """The attention backward on the card: (dq, dk, dv) in the inputs' dtype
    from q, k, v, the forward's o, its gradient ``do`` (all contiguous,
    one dtype: bf16 takes the wgmma route, whose TMA loads need o and do
    16-byte aligned too, fp32 the split-TF32 one, whose cp.async loads need
    the same and whose launch fails with cudaErrorMisalignedAddress
    otherwise) and the forward's fp32 ``lse`` (B, H, Sq). head_dim 16 to
    256 on both routes. ``split``: the dK/dV walk's P (``bwd_plan``; None:
    the planner's). Two launches on the same inputs give the same bits."""
    dq, dk, dv, delta, parts, dq_ws, turns, split = _bwd_outputs(
        q, k, v, o, do, lse, causal, window, q_offset, "cuda", split)
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    group = (dq_group(b, n_kv, split, -(-skv // BWD_KEYS),
                      card_slots(q.dtype, d, q.device.index)) if turns is not None else 1)
    fused = (ptr(dq_ws), ptr(turns), group) if q.dtype == torch.bfloat16 else ()
    with torch.cuda.device(q.device):
        err = _bwd(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), b, h, n_kv, sq, skv, d,
                            int(bool(causal)), int(window), int(q_offset), float(d ** -0.5),
                            split, ptr(parts), *fused, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BWD_ROUTES[q.dtype][0]} launch failed (split {split}): "
                           f"cudaError {err}")
    flash_attention_bwd_cuda.launches += 1
    cost.report_attention(q, k, v, (dq, dk, dv, delta), (o, do, lse), causal=causal,
                          window=window, q_offset=q_offset, backward=True)
    return dq, dk, dv


# backward calls (three kernels each, four with a split walk) since the last reset
flash_attention_bwd_cuda.launches = 0


def flash_attention_bwd_meta(q, k, v, o, do, lse, *, causal=True, window=0,
                             q_offset=0, split=None):
    """The backward's shape function on meta tensors (the dry-run's): the
    checks and allocations of ``flash_attention_bwd_cuda`` (dq, dk, dv, the
    fp32 Δ scratch, with a split walk the fp32 parts, planned for an H100's
    slots, and on the fused route the fp32 dQ workspace and the turn
    counters), its cost reported (``cost``: what the kernels must do, the
    scratch not counted), no launch."""
    dq, dk, dv, delta, *_ = _bwd_outputs(q, k, v, o, do, lse, causal, window, q_offset,
                                         "meta", split)
    cost.report_attention(q, k, v, (dq, dk, dv, delta), (o, do, lse), causal=causal,
                          window=window, q_offset=q_offset, backward=True)
    return dq, dk, dv


def _bwd_outputs(q, k, v, o, do, lse, causal, window, q_offset, device, split):
    """The backward's checks on ``device``'s tensors, and its outputs and
    scratch, allocated: (dq, dk, dv, the fp32 Δ, the fp32 parts (2, P, B,
    KV, Skv, D) of dK and dV or None at P = 1, on the fused route the fp32
    dQ workspace (B, H, Sq, D) and the int32 turn counters (B, H, ceil(Sq /
    64)) or None twice, P)."""
    _check(q, k, v, device)
    b, h, sq, _ = q.shape
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention_bwd_cuda: window and q_offset must be >= 0")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be contiguous "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd_cuda: {name} starts at a pointer that "
                             "is not 16-byte aligned (TMA needs it); pass a fresh "
                             "contiguous copy")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_cuda: lse must be contiguous fp32 "
                         f"{(b, h, sq)} on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    split = bwd_plan(q, k, causal=causal, window=window, q_offset=q_offset, split=split)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    parts = (torch.empty((2, split, *k.shape), dtype=torch.float32, device=q.device)
             if split > 1 else None)
    dq_ws = turns = None
    if bwd_fuses_dq(q.shape[-1], q.dtype):  # both scratch: the kernels write before they read
        dq_ws = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        turns = torch.empty((b, h, -(-sq // BWD_KEYS)), dtype=torch.int32, device=q.device)
    return dq, dk, dv, delta, parts, dq_ws, turns, split


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with gradients on the card: the forward kernel, which
    also writes the rows' logsumexp, and the backward kernel. Both are
    deterministic, so a recompute under ``torch.utils.checkpoint``
    reproduces ``o`` and ``lse`` bit for bit."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        fwd = flash_attention_meta if q.is_meta else flash_attention_cuda
        o, lse = fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_meta if q.is_meta else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None, None, None
