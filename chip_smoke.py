#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100. Run from the root of a checkout:

    python3 chip_smoke.py

Phases; any failure makes the script exit non-zero:

1. The card: CUDA must be available; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for fp32 products.
2. The build: compiles every kernel source of the port with nvcc, all at
   once, and prints the build time and ptxas's registers, shared memory
   and spills; a spill, or ptxas's advisory that wgmma instructions are
   serialized, fails the phase, and so does a bf16 flash library (forward
   or backward) whose SASS (cuobjdump) holds no HGMMA or an fp32 flash
   library (forward or backward) whose SASS holds no TF32 tensor-core
   instruction (HMMA or HGMMA on TF32). Prints each flash route's dynamic
   shared memory per block at each head dim (forward and backward), the
   RG-LRU scan's per dtype and its backward's.
3. Kernels against plain: each kernel against its plain PyTorch version on
   the card over a case list (flash: 2e-5 in fp32, 2e-2 in bf16, with bf16
   cases at every head dim whose lengths no tile divides; RG-LRU scan:
   1e-5 in fp32, 2e-2 in bf16, and equal bit for bit, with cases at the
   edges of its ring: one step, fewer steps than a stage, widths off its
   16-lane tile and off 16-byte rows, exact a = 0 and a = 1, a view that
   starts off 16 bytes); a misaligned contiguous view must raise
   ValueError in flash; two launches on the same inputs must agree bit
   for bit at each main-path shape of both kernels and at each fp32 flash
   shape. Then CUDA-event times of the kernel, the
   plain version and, where there is one, the one PyTorch call that
   computes the same function (kernel and library call: device time over
   a replayed CUDA graph, and the eager time of a call, host included),
   beside the card's least time for the work,
   at the shapes the main paths give each kernel (flash: the bf16 wgmma
   route at its nine shapes, and the fp32 split-TF32 route at the seven
   shapes the fp32 logits checks of phases 4-5d and 5g give it, B8 S512 of
   each decoder-only arch and whisper's B8 H6 S1500 D64 bidirectional
   encoder and S448 causal decoder, beside both its split-TF32 bound and the
   fp32 CUDA-core bound; SDPA with the same mask), with the scan's GB/s, its share of the bound
   and, as a yardstick of the rate the card reaches for the same bytes, an
   elementwise ``torch.add`` of a and b into h. Then the scan's backward
   (csrc/rglru_bwd.cu, run right after the scan): equal to its plain
   version bit for bit over the scan's edge cases, each with and without
   h0 and h_last's gradient, exact a = 0 and a = 1 and a view off 16 bytes,
   two launches bit-equal, and its time at recurrentgemma-2b's train shape
   (B8 S512 W2560 fp32) beside its bound and, as a yardstick, one
   ``torch.addcmul`` of a, h and g.
4. smollm-360m at full width: ``ServeEngine("smollm-360m", tiny=False)``
   (32 layers, stacked layout, seeded random weights) serves 3 ``infer``
   requests and one ``generate`` of 8 prompts of 512 tokens, 32 new tokens
   each. Launch counts are set to 0 just before and read just after: each
   prefill must launch the flash kernel once per layer. Then per-layer
   attention (within 2e-2 plus the bound of its bf16 probabilities) and
   prefill's last logits through the kernel are held against the plain
   versions (``force="ref"``), in bf16 and in fp32; the fp32 run (the
   fp32 route's main path) must launch the flash kernel once per layer,
   with fp32 inputs, counted from 0 just before it.
5. recurrentgemma-2b at full width (26 layers: 18 rglru + 8 local
   attention, head_dim 256, MQA; list layout; seeded random weights): the
   same 3 ``infer`` requests, one ``generate`` of 8 × 512 → 32 tokens and
   one of 1 × 3072 → 8 tokens, which crosses the 2048 window. Each prefill
   must launch the RG-LRU scan once per rglru layer and the flash kernel
   once per attention layer. Then each layer's kernel against its plain
   version on that layer's own inputs, and the last logits through both
   kernels against both plain versions, the fp32 run again counted (8
   flash, 18 scan launches); the scan must equal its plain version bit for
   bit on every layer.
5b-5d. llama3-8b (32 layers, d_model 4096, 32/8 heads, head_dim 128, vocab
   128,256, untied), granite-moe-3b-a800m (32 layers, 24/8 heads, head_dim
   64, 40 experts top-8) and qwen2.5-3b (36 layers, 16/2 heads, head_dim
   128, QKV bias) at full width, stacked layout, seeded random weights
   (``phase_decoder``): the 3 ``infer`` requests and one ``generate`` of 8 x
   512 -> 32 tokens, counted (one flash launch a layer a prefill);
   per-layer attention as in phase 4; one profiled ``generate`` (8 x 512
   -> 8): each phase's busy share and the prefill's device time by part
   (flash, the fp32 unembedding, the MoE's router, dispatch, experts and
   combine, the other GEMMs, the rest) and its host time by span; qwen2.5's QKV bias against one
   rounding of the fp32 product plus the bias; granite's routing choices
   that differ between the kernel and plain paths, per layer, and two
   prefills bit-equal; then the last logits as in phase 4 (the fp32 run
   counted), an MoE arch's with its routing pinned to the plain path's
   choices (the same runs with their own routing reported), its fp32
   routing held (at most 0.01% of the choices move, pinned or free; in the
   pinned run, only at plain-path gaps within 1e-5 of a tie), and the peak
   memory of those checks.
5e. chameleon-34b, deepseek-coder-33b and qwen3-moe-235b-a22b at their
   tiny configs on the card: a prefill and 6 greedy decode steps through
   the kernels against the plain path, in fp32 (last logits within 1e-3,
   tokens equal where the plain path's margin decides them) and bf16
   (within 0.1); one flash launch a layer a prefill.
5g. whisper-tiny at full width (4 encoder and 4 decoder layers, d_model
   384, 6 heads of 64, tied vocab 51,865, 1500 frames, seeded random
   weights; ``phase_whisper``): 3 ``infer`` requests and one ``generate``
   of 8 x 1500 bf16 stub frames -> 32 tokens, counted (4 flash launches,
   bidirectional, a request; none in decode); the encode's time; a profiled
   generate (busy shares of encode and decode, the encode's device time by
   part: flash, GEMMs, the rest); the prefill step (encode plus the
   teacher-forced decoder) on 8 x 448 tokens, counted (8 flash launches);
   each layer's attention, encoder and decoder, through the kernel against
   the plain version on its own inputs (as in phase 4); its last logits
   against the plain path as in phase 4 (bf16 within 0.1 or the spread of
   correct bf16 paths; fp32, with fp32 frames and params on the fp32
   route, within 1e-3 with its 8 launches counted); the fp32 decode
   hand-off: S decode steps against the teacher-forced decoder over the
   same S tokens, at S = 1 and 64, last logits within 1e-3 and every
   position's argmax equal where the plain margin decides it.
5f. xlstm-125m at full width (12 layers alternating mlstm / slstm, d_model
   768, 4 heads, list layout, seeded random weights; ``phase_xlstm``): the
   3 ``infer`` requests, ``generate`` 8 x 512 -> 32 and 1 x 2048 -> 8,
   counted (no kernel of the port is on this path: every count must be
   0); a profiled generate (busy shares; the prefill's device and host time
   by part: the sLSTM loop, the chunkwise mLSTM, the unembedding); then in
   fp32 on the same weights the chunkwise mLSTM against its stepwise oracle
   through the model at 1 x 2048 (four chunks of 512) and 8 x 512, and the
   decode hand-off (a prefill of S, then one decode step, against S + 1
   tokens in one pass) at S = 511 and 2048, each last logits within 1e-3.
6. The flash backward (run right after phase 3), both routes on the tensor
   cores: bf16 on wgmma (csrc/flash_attention_bwd_sm90.cu), fp32 as
   split-TF32 mma.sync (csrc/flash_attention_bwd.cu). The kernel against
   its plain version over a case list (fp32 and bf16, head_dim 16 to 256,
   GQA, MQA and MHA, causal, window and bidirectional, ragged lengths, Sq
   != Skv with an offset, qwen2.5's GQA 8:1 at head_dim 128 and granite's
   3:1; at head_dim 256 MQA, ragged lengths, an offset and a 2048 window
   that masks at S3072), each
   gradient within 2e-5 (fp32) or 2e-2 (bf16) of the
   largest magnitude of that gradient, given the forward kernel's o and
   lse; the forward's lse within 1e-5 of the plain logsumexp; two launches
   bit-equal; a bf16 do that starts off 16 bytes raises ValueError with no
   launch. Times at the train paths'
   shapes (B8 H15 KV5 S512 and S2048, D64, B8 H10 KV1 S512 D256, B8 H16
   KV2 S512 D128, B8 H24 KV8 S512 D64 and whisper's B8 H6 S448 D64, bf16,
   causal, and whisper's encoder, B8 H6 S1500 D64 bidirectional) and of
   the fp32 route at smollm's S512 and recurrentgemma's B8 H10 KV1 S512
   D256 beside SDPA's backward (fwd+bwd minus fwd, both over replayed
   graphs; fp32 with TF32 off), each split into its three kernels by the
   profiler over the replayed graph (a session that lost kernel records,
   each kernel seen at most once a call and some less, is taken again, up
   to SPLIT_SESSIONS; every session's counts are in the kernels line). Then, with grad on, a flash output's
   grad_fn must be FlashAttentionFn and a scan output's RGLRUScanFn, and
   an fp32 flash output at head_dim 256 must launch the backward once,
   its gradients within 2e-5 of the plain ones.
7. Full-width training after the serving phases
   (``phase_train_full_width``): smollm-360m (32 layers),
   recurrentgemma-2b (26 layers: 18 rglru + 8 local attention, list
   layout), qwen2.5-3b (36 layers, QKV bias drawn nonzero from a seed) and
   granite-moe-3b-a800m (32 layers, the MoE FFN), remat full, bf16,
   true-fan-in attention projections, deterministic algorithms, B8 x S512,
   the state updated in place by the step (two fp32 optimizer states of
   2.7-3.3 B params would not fit the card). Step 0 through the kernels,
   its launches counted, against the same step on the plain versions, loss
   and grad norm within 2e-2 (``step0``; granite's with its routing pinned
   to the plain step's, after its fp32 routing on the same batch is gated
   as in phases 5b-5d); 3 steps counted from 0 (a step: two flash forwards
   and one backward an attention layer, two scan forwards and one backward
   an rglru layer); the same 3 steps again bit-equal (the first run's state
   kept on the host); one profiled step for the step time, tokens/s, peak
   memory, busy share and the kernels' shares of it; one more step counted
   by ``launch.op_cost`` (its ATen ops and kernel calls), the peak device
   memory reset just before it.
7a. The dry-run (``phase_dryrun``): each of those four steps counted again
   on meta tensors (``launch.dryrun.run_cell``, no mesh, no process group):
   the predicted peak within 10% of that counted step's
   ``torch.cuda.max_memory_allocated``, the meta FLOPs within 1e-6
   (relative) of its executed count, and ``mfu`` (FLOPs over step time x
   989 TFLOP/s) printed beside the card's name and power limit. Then the
   dry-run's CLI, each in a process of its own, both started before the
   counts: recurrentgemma-2b ``train_4k`` on a fake 16x16 mesh and
   llama3-8b ``prefill_32k`` on a fake 2x16x16 one must exit 0.
7b. xlstm-125m's training at full width through the same phase (no step 0
   against a plain path: none of the port's kernels is on it; 2 steps
   twice, not 3: its host-bound steps take 7-12 s each), and the
   sLSTM loop's and the chunkwise mLSTM's shares of the profiled step, in
   host time and in device time (their spans, and the backward calls of
   the autograd nodes made inside them). Then one fp32 step at B2 x S128 on
   the card, under deterministic algorithms (``torch.cumsum`` of a float
   CUDA tensor would raise), against the same step of the port on the CPU
   from the same weights: loss within 1e-5 and grad norm within 1e-4
   relative (``phase_cpu_step``).
7c. whisper-tiny's training at full width through the same phase: B8 x
   S448 tokens of the synthetic stream and bf16 frames (8, 1500, 384), no
   remat (the reference's encoder-decoder has none), bf16, true-fan-in
   self- and cross-attention, deterministic algorithms; step 0 against the
   plain step within 2e-2; 3 steps counted (8 flash forwards and 8
   backwards a step, 4 of each bidirectional at S1500); the same 3 steps
   again bit-equal; one profiled step. Then one fp32 step at B2 x S64 (all
   1500 frames) on the card against the CPU's: loss within 1e-6 and grad
   norm within 1e-5 relative (``phase_cpu_step``).
8. The same smollm-360m step 0 in fp32 (the fp32 routes' train path: 64 +
   32 launches, within TRAIN_TOL_FP32 = 5e-5 of the plain path's).
   recurrentgemma-2b's fp32 training at full width
   (``phase_train_fp32_d256``: 26 layers, the fp32 flash backward at
   head_dim 256 and the scan's backward on its path, remat full,
   true-fan-in weights, deterministic algorithms): the batch at S512 is
   the largest whose dry-run peak (``launch.dryrun.run_cell``, this PR's
   meta route) leaves 10% of the card's 80 GB free; step 0 against the
   plain step within TRAIN_TOL_FP32 (16 + 8 flash and 36 + 18 scan
   launches); 2 steps counted and timed, their peak within 10% of the
   prediction; one profiled step for the busy share. Then a
   real job through the port's own ``FfDLPlatform`` on the card
   (``phase_crash_resume``): smollm-360m's tiny config, 60 steps,
   checkpoint every 20, submitted with ``ApiClient.for_platform`` through
   the v1 API tier, placed by the gang scheduler, deployed by the guardian,
   which builds ``TorchLearner`` on the platform's default device; its
   learner is killed at step 30 and its pod failed, the guardian restarts
   it from the step-20 checkpoint, and the job must end COMPLETED, its
   status history through DEPLOYING, DOWNLOADING, PROCESSING and STORING,
   with exactly one restart, on the uninterrupted job's state bit for bit;
   the uninterrupted job's launches must equal ``step_launches(cfg, 60)``.
   Then recurrentgemma-2b's tiny config in fp32 at head_dim 256 (a job
   manifest's config overrides) as a job through the platform on the card
   (``phase_platform_fp32``: 20 steps, a checkpoint at step 10): COMPLETED
   with its status history, its launches ``step_launches(cfg, 20)``, and
   its per-tick losses within FP32_JOB_TOL of the same job through the
   port's platform on the CPU.
8d. smollm-360m at full width and 4 of its 32 layers as a job through the
   platform (``phase_platform_full_width``): 6 steps at B8 x S512, bf16,
   remat full, checkpoint every 3, beside two SimLearner gang jobs of a tenant with a
   4-chip quota (one admitted over it); crashed once after its step-3
   checkpoint, it must resume from step 3 and end COMPLETED, bit-equal to
   the uninterrupted job's final state, each run's flash launches counted
   against ``step_launches``. Prints the object store's bytes, each
   checkpoint save's time and the wall time a step through the platform
   beside the same step run bare at the same depth (and phase 7's at 32
   layers), with the card's name and power limit.
8b. llama3-8b, deepseek-coder-33b, chameleon-34b and qwen3-moe-235b-a22b
   at their tiny configs: one bf16 and one fp32 step each through the
   kernels (both routes of the forward and the backward) against the plain
   path, within 2e-2 and TRAIN_TOL_FP32 (qwen3-moe's routing pinned).
8c. The mesh (``phase_mesh``): an NCCL process group of world size 1
   (probed by an all-reduce and a barrier) and a 1x1 (data, model)
   ``DeviceMesh`` on the card. qwen2.5-3b trains on it at full width (bf16,
   remat full, B8 x S512, params and the ZeRO-1 optimizer state as
   DTensors, the kernels on each rank's local shards): step 0 within 2e-2
   of phase 7's unsharded step 0 (whether bit-equal is printed), 3 steps
   counted from 0 (the unsharded step's 72 flash forwards and 36 backwards
   a step), the same 3 steps again bit-equal, step time and peak memory
   beside phase 7's. recurrentgemma-2b, granite-moe-3b-a800m and
   qwen3-moe-235b-a22b at their tiny configs: one bf16 and one fp32 step
   each on the mesh against the unsharded step (2e-2, TRAIN_TOL_FP32), the
   scan's launches counted; at model 1 the reference's pick is the
   token-parallel MoE branch for both MoE archs (the expert-parallel
   branch needs a model axis of 2 or more: the gloo tests hold it).
   smollm-360m serves at full width through
   ``ServeEngine(mesh="1x1")``, without and with ``ctx_parallel``:
   ``generate`` 8 x 512 -> 8 counted (one flash launch a layer), the
   greedy tokens equal to an unsharded engine's wherever its top-1 margin
   decides them, and the fp32 prefill's last logits within 1e-3 (32 fp32
   flash launches). whisper-tiny serves at full width through
   ``ServeEngine(mesh="1x1")`` too: ``generate`` B8 x 1500 frames -> 8,
   its frames placed by ``shard_batch`` and its decode state by its
   logical axes, counted (one flash launch an encoder layer, as the
   unsharded engine's), its greedy tokens held as smollm's. A train state
   saved from the mesh restores unsharded, and one saved unsharded
   restores onto the mesh, bit for bit.
8e. FfDL's serving tier (``phase_serving_tier``): the port's
   ``Federation`` of two shards on the card (its default device) with the
   autonomous operator installed; an ``AdminClient`` creates a tenant with
   a 4-chip quota and a rate limit; the tenant's ``WorkloadClient`` applies
   a Pipeline whose ``train`` stage is a real job (smollm-360m's tiny
   config, 20 steps, trained by ``TorchLearner`` on the card) and whose
   ``serve`` stage materializes a Service. Ticked until the stage's job is
   COMPLETED (its stage DONE) and the Service RUNNING, the tenant's bus
   events in the DAG's order, the stage's flash launches equal to
   ``step_launches(tiny cfg, 20)``. Then a full-width smollm-360m
   ``ServeEngine`` (bf16, seeded weights) is attached to the Service and
   invoked through the workloads gateway 4 times at B8 x S512 -> 32
   tokens, each invoke counted from 0 (32 bf16 flash forwards, one a
   layer); the Service is re-applied with 2 replicas and invoked twice
   more, the replies alternating between the replica slots. Prints each
   invoke's prefill and decode ms a token and the phase's wall time beside
   the card's name and power limit.
8f. FfDL's wire (``phase_wire``): the port's two-shard ``Federation`` on
   the card behind ``ApiHttpServer`` on 127.0.0.1 with a rate limit; an
   operator key creates a tenant over ``POST /v2/admin/tenants``; the
   tenant's ``HttpTransport`` submits the same real job as 8e's train stage
   over ``POST /v1/jobs``, followed by ``ffdl logs --follow`` on one SSE
   stream to COMPLETED, its flash launches equal to ``step_launches``, its
   final state bit-equal to the same manifest's job in-process. Then a
   Service applied over ``POST /v2/workloads``, a full-width smollm-360m
   ``ServeEngine`` attached, invoked 4 times over ``POST
   /v2/workloads/{name}/invoke`` at B8 x S512 -> 32 (32 flash launches
   each), its tokens equal to a second engine's of the same seed given the
   same payloads in-process; ``GET /metrics`` counts each route's
   requests. Prints each invoke's wall time over the wire beside the
   engine's prefill and decode, the job's and the phase's wall time and
   the card's name and power limit.
8g. The port's five examples on the card (``phase_examples``), each
   ``main`` run in-process with ``--device cuda``: ``torch_quickstart``
   (a simulated and a real tiny smollm job, 40 steps), ``torch_multi_tenant``
   in-process and ``--http`` (simulated tenants' jobs), ``torch_pipeline_e2e``
   (examples/manifests/pipeline.yaml through a two-shard ``Federation``,
   its Service invoked 4 times and scaled to 3), ``torch_chaos_drill`` (a
   fleet under seeded chaos) and ``torch_train_e2e --quick`` (the tiny
   config, 150 steps, HALT and RESUME; at its default size, a ~100M decoder
   for 300 steps, it takes longer than the script's limit leaves). Every
   job COMPLETED, the loss trail falling, the launches
   counted from 0 for each (whole train steps: quickstart's exactly 40),
   each transcript and wall time printed beside the card's name and power
   limit. The port's lock-order witness (``repro_torch.analysis.witness``)
   is installed on the port's ``RWLock`` from phase 8 to here: its
   acquisitions and edges are printed, and the run fails on a cycle or on
   no acquisition at all.
9. One JSON line ``{"kernels": [...]}``, then, as the last line,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package. With no CUDA, or outside
a checkout of the repository, it fails before printing any result.
"""

import bisect
import contextlib
import dataclasses
import gc
import http.client
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch.analysis.witness import witness as lock_witness  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, get_tiny_config  # noqa: E402
from repro_torch.api import (  # noqa: E402
    AdminClient,
    ApiClient,
    ApiHttpServer,
    Federation,
    HttpTransport,
    RateLimitConfig,
    SubmitRequest,
    WorkloadClient,
)
from repro_torch.api import cli as ffdl_cli  # noqa: E402
from repro_torch.api.ops import install_operator  # noqa: E402
from repro_torch.core import FfDLPlatform, JobManifest  # noqa: E402
from repro_torch.core.types import TERMINAL  # noqa: E402
from repro_torch.data.objectstore import MountedBucket, ObjectStore  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_ROUTES,
    HEAD_DIMS,
    ROUTES,
    bwd_smem_bytes,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    smem_bytes,
)
from repro_torch.kernels.rglru import bwd_smem_bytes as scan_bwd_smem_bytes  # noqa: E402
from repro_torch.kernels.rglru import (  # noqa: E402
    bwd_uses_tma,
    rglru_scan_bwd_cuda,
    rglru_scan_cuda,
    uses_tma,
)
from repro_torch.kernels.rglru import smem_bytes as scan_smem_bytes  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch.mesh import init_process_group, make_env, make_mesh  # noqa: E402
from repro_torch.launch.serve import PHASES, ServeEngine, _install_prefill  # noqa: E402
from repro_torch.launch.train import deterministic  # noqa: E402
from repro_torch.models import encdec, lm, steps  # noqa: E402
from repro_torch.nn import attention, blocks, layers, moe, recurrent  # noqa: E402
from repro_torch.nn.policy import interior_einsum  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import param_shardings, use_env  # noqa: E402
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map_with_path  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s of HBM3 and
# FLOP/s by operand type (bf16 and TF32 on tensor cores, fp32 on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
BLOCK_SMEM_BYTES = 232_448  # dynamic shared memory a block may use on an H100
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
# The fp32 flash route does its fp32-accurate work as three TF32 products
# (lo.hi' + hi.lo' + hi.hi', csrc/flash_attention.cu).
SPLIT_TF32_PRODUCTS = 3
# Prefill logits through the kernels vs the plain versions, at full depth:
# in bf16 each path rounds its fp32 results to bf16 on its own, and the
# residual stream carries those one-ulp differences through every layer
# (``check_logits`` widens the bf16 bound to the spread of correct bf16 paths
# where that is larger); in fp32 only the order of the sums differs.
LOGITS_TOL = {torch.bfloat16: 0.1, torch.float32: 1e-3}
# An MoE router's choices in the fp32 logits check. With the upstream routing
# pinned to the plain path's, a layer's router input differs from the plain
# path's only by the kernels' fp32 sums in another order, which moves a
# router probability (at most 1, softmax over the experts) by far less than
# 1e-5: a choice the kernel path would make differently must sit within
# ROUTE_GAP_TOL of a tie on the plain path. A fault that moves the router's
# input moves choices with wide gaps, and many of them: at most
# ROUTE_FLIP_LIMIT of all the (token, choice) pairs may move, pinned or not.
ROUTE_GAP_TOL = 1e-5
ROUTE_FLIP_LIMIT = 1e-4
# The bf16 route rounds each unnormalized probability to bf16 as the A
# operand of P.V, where the reference model's chunked twin rounds it
# (src/repro/nn/attention.py:95). Each moves by at most bf16's unit roundoff
# 2^-8 of itself, so an output moves by at most 2^-8 (softmax . |V|) beyond
# what the plain version (fp32 probabilities) gives: the per-layer bound
# adds that term (``attention_within``).
P_ROUNDING = 2.0 ** -8

# (B, H, KV, S, D, causal, window), the cases of tests/test_kernels.py
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, 0),
    (1, 8, 8, 128, 128, True, 0),
    (2, 4, 1, 256, 64, True, 64),
    (1, 2, 2, 128, 64, False, 0),
    (1, 15, 5, 128, 64, True, 0),
    (2, 2, 2, 512, 32, True, 128),
]
EXTRA_CASES = [
    (2, 4, 2, 256, 16, True, 0),       # head_dim 16 (smollm tiny)
    (2, 8, 2, 256, 128, True, 0),      # head_dim 128, GQA
    (1, 4, 2, 200, 64, True, 0),       # ragged length
    (2, 15, 5, 1000, 64, True, 0),     # ragged length, smollm heads
    (1, 4, 1, 1000, 128, True, 256),   # ragged length, local window
    (2, 10, 1, 1000, 256, True, 256),  # head_dim 256, MQA, window, ragged
    (1, 2, 1, 300, 256, False, 0),     # head_dim 256, bidirectional
]
# The main paths' attention prefill shapes: (B, H, KV, S, D, causal, window)
FLASH_MAIN = {
    "smollm B8 S512": (8, 15, 5, 512, 64, True, 0),
    "smollm B8 S2048": (8, 15, 5, 2048, 64, True, 0),
    "recurrentgemma B8 S512": (8, 10, 1, 512, 256, True, 2048),
    "recurrentgemma B1 S3072": (1, 10, 1, 3072, 256, True, 2048),
    "llama3 B8 S512": (8, 32, 8, 512, 128, True, 0),
    "qwen2.5 B8 S512": (8, 16, 2, 512, 128, True, 0),
    "granite B8 S512": (8, 24, 8, 512, 64, True, 0),
    # whisper-tiny: the encoder's bidirectional self-attention over 1500
    # frames (no 64- or 128-row tile divides it), the decoder's causal
    # self-attention in the prefill step and in training
    "whisper enc B8 S1500": (8, 6, 6, 1500, 64, False, 0),
    "whisper dec B8 S448": (8, 6, 6, 448, 64, True, 0),
}
# The fp32 route's shapes: those the fp32 logits checks give it
FLASH_FP32 = ("smollm B8 S512", "recurrentgemma B8 S512", "llama3 B8 S512",
              "qwen2.5 B8 S512", "granite B8 S512", "whisper enc B8 S1500",
              "whisper dec B8 S448")
# The decoder-only attention archs served at full width (phases 5b-5d), and
# those whose tiny configs are served on the card (phase 5e; the full widths
# of 33-235 B params do not fit one card beside an fp32 check)
FULL_WIDTH_ARCHS = ("llama3-8b", "granite-moe-3b-a800m", "qwen2.5-3b")
TINY_ARCHS = ("chameleon-34b", "deepseek-coder-33b", "qwen3-moe-235b-a22b")
# The archs trained at full width (phase 7: the three larger train states
# take 38-46 GB), and those trained at their tiny configs only (phase 8b:
# llama3-8b's state needs about 128 GB, the others' more)
TRAIN_FULL_WIDTH = ("smollm-360m", "recurrentgemma-2b", "qwen2.5-3b", "granite-moe-3b-a800m")
# The dry-run phase: phase 7's steps counted on meta tensors, beside the same
# steps executed on the card (peak device memory, the executed count); the
# bounds below are the phase's gates. And two production cells of the CLI.
DRYRUN_PEAK_TOL = 0.10  # relative, predicted against measured peak
DRYRUN_FLOPS_TOL = 1e-6  # relative, meta against executed FLOPs
DRYRUN_CELLS = (("recurrentgemma-2b", "train_4k", False), ("llama3-8b", "prefill_32k", True))
# xlstm-125m: pure recurrent (mLSTM and sLSTM blocks), no kernel on its path
XLSTM = "xlstm-125m"
XLSTM_GENERATES = [(8, 512, 32), (1, 2048, 8)]  # 2048: four mLSTM chunks of 512
XLSTM_TOL = 1e-3  # fp32 last logits, two correct forms (LOGITS_TOL's fp32)
XLSTM_TRAIN_STEPS = 2  # its steps are host-bound, 7-12 s each: two runs of 2, not 3
# whisper-tiny: the encoder-decoder, its encoder bidirectional over 1500
# frames; 3 infer requests and one generate of 8 x 1500 frames -> 32 tokens
# (the prompt sets only the batch and the cache's capacity, as in the
# reference); the prefill step and training on the decoder's 448 trained
# positions; the fp32 decode hand-off at S = 1 and 64
WHISPER = "whisper-tiny"
WHISPER_GENERATES = [(8, 16, 32)]
WHISPER_SEQ = 448
WHISPER_HANDOFF = (1, 64)
# The card's fp32 train step against the CPU's: (B, S), relative tolerances
CPU_STEP = {XLSTM: ((2, 128), {"loss": 1e-5, "grad_norm": 1e-4}),
            WHISPER: ((2, 64), {"loss": 1e-6, "grad_norm": 1e-5})}
TINY_TRAIN_ARCHS = ("llama3-8b", "deepseek-coder-33b", "chameleon-34b", "qwen3-moe-235b-a22b")
TINY_DECODE_STEPS = 6
# The mesh phase (8c): one process, a 1x1 (data, model) mesh over an NCCL
# group of world size 1. qwen2.5-3b trains on it at full width, these tiny
# configs take a step each (the scan's path, token-parallel MoE at model 1),
# and smollm-360m serves on it.
MESH_ARCH = "qwen2.5-3b"
MESH_TINY = ("recurrentgemma-2b", "granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
MESH_SERVE = "smollm-360m"
MESH_SERVE_GEN = 8  # a decode step on DTensors is host-bound, 0.4 s: 8 tokens, not 32
MESH_WHISPER_GEN = 8  # whisper's decode on DTensors is host-bound: a few steps
# Kernel names of cuBLAS's and CUTLASS's GEMMs (the profiled prefill's split)
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.IGNORECASE)
# (B, S, W): tests/test_kernels.py's cases, ragged ones, the edges of the
# kernel's ring (16-lane tiles, 64-step stages, TMA only on 16-byte rows),
# and the main paths'
RGLRU_CASES = [(8, 256, 128), (2, 512, 256), (1, 128, 512), (16, 64, 128),
               (3, 100, 200), (1, 37, 96),
               (2, 1, 256),    # one step
               (2, 40, 128),   # fewer steps than one stage
               (1, 200, 64),   # steps not a multiple of the stage
               (2, 70, 37),    # odd width: rows off 16 bytes, a ragged lane tile
               (1, 1, 37),     # both
               (5, 64, 24),    # the last block of each row half empty
               (2, 65, 36),    # fp32 rows on 16 bytes, bf16 rows not
               (1, 700, 40)]   # the ring wraps 2.7 times
RGLRU_MAIN = {"recurrentgemma B8 S512": (8, 512, 2560),
              "recurrentgemma B1 S3072": (1, 3072, 2560)}
INFER_PAYLOADS = [{"prompt_len": 128, "gen": 8, "batch": 2},
                  {"prompt_len": 64, "gen": 4}, {}]
# The attention backward against its plain version: each gradient within
# BWD_TOL of the largest magnitude of that gradient (fp32: fp32 sums in
# another order; bf16: the gradients are rounded to bf16), the forward's
# logsumexp within LSE_TOL (absolute and relative). Cases (B, H, KV, Sq,
# Skv, D, causal, window, q_offset): every head dim the backward takes,
# GQA, MQA and MHA, causal, window and bidirectional, lengths no 64-tile
# divides, Sq != Skv with an offset, a suffix q.
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5
BWD_CASES = [
    (2, 4, 2, 256, 256, 16, True, 0, 0),
    (2, 4, 2, 256, 256, 32, True, 0, 0),
    (2, 4, 2, 256, 256, 64, True, 0, 0),
    (1, 8, 2, 256, 256, 128, True, 0, 0),
    (2, 4, 1, 256, 256, 64, True, 64, 0),
    (1, 2, 2, 128, 128, 64, False, 0, 0),
    (1, 15, 5, 1000, 1000, 64, True, 0, 0),
    (1, 4, 1, 1000, 1000, 128, True, 256, 0),
    (1, 4, 2, 300, 300, 16, False, 0, 0),
    (2, 6, 2, 100, 300, 32, True, 96, 200),
    (1, 4, 4, 64, 256, 128, True, 0, 192),
    (1, 16, 2, 600, 600, 128, True, 0, 0),  # qwen2.5's GQA 8:1 at head_dim 128, ragged
    (2, 24, 8, 300, 300, 64, True, 0, 0),   # granite's GQA 3:1, ragged
]
# head_dim 256 (recurrentgemma's), both routes: MQA with its 10-head group,
# ragged lengths, Sq != Skv with an offset, bidirectional, and its 2048
# window masking at S3072
BWD_CASES_D256 = [
    (2, 10, 1, 512, 512, 256, True, 0, 0),
    (1, 10, 1, 1000, 1000, 256, True, 256, 0),
    (2, 6, 2, 100, 300, 256, True, 96, 200),
    (1, 2, 1, 300, 300, 256, False, 0, 0),
    (1, 10, 1, 3072, 3072, 256, True, 2048, 0),
]
# The train paths' attention backward shapes (B, H, KV, S, D, causal), bf16,
# and the ones the fp32 route is timed at (its kernels line reads the first)
BWD_MAIN = {"smollm train B8 S512": (8, 15, 5, 512, 64, True),
            "smollm B8 S2048": (8, 15, 5, 2048, 64, True),
            "recurrentgemma train B8 S512": (8, 10, 1, 512, 256, True),
            "qwen2.5 train B8 S512": (8, 16, 2, 512, 128, True),
            "granite train B8 S512": (8, 24, 8, 512, 64, True),
            "whisper enc train B8 S1500": (8, 6, 6, 1500, 64, False),
            "whisper dec train B8 S448": (8, 6, 6, 448, 64, True)}
BWD_FP32 = ("smollm train B8 S512", "recurrentgemma train B8 S512")
# The backward's kernels by their names in the sources (the profiler's names
# carry template arguments): flash_bwd_{delta,dkdv,dq}, with _sm90 on the
# bf16 route
SPLIT_SESSIONS = 3  # profiler sessions for a complete split of the backward
BWD_KERNEL = re.compile(r"flash_bwd_[a-z0-9]+(?:_sm90)?")
# Full-width training: B x S tokens a step, the steps of each run, and the
# first step's loss and grad norm through the kernels against the plain
# versions: the bf16 tolerance (the forward kernel rounds P to bf16 for
# P.V, the plain version keeps it fp32; bf16 gradients carry that).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 3
# Jobs through the port's FfDLPlatform (phases 8 and 8d): the tiny job of
# tests/test_torch_learner.py (checkpoint every 20, crashed at step 30) and
# the full-width one (checkpoint every 3, crashed after its step-3
# checkpoint) at PLATFORM_LAYERS of its 32 layers: its four checkpoint saves
# at 32 layers took about 150 s of the script's time limit, at 8 layers
# 72-76 s on a slow host; each must pass these statuses in this order.
PLATFORM_ARCH = "smollm-360m"
PLATFORM_LAYERS = 4
TINY_JOB = {"steps": 60, "batch": 4, "seq": 64, "seed": 3}
FULL_JOB = {"tiny": False, "overrides": {"n_layers": PLATFORM_LAYERS}, "steps": 6,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "seed": 3}
FULL_JOB_CKPT = 3
# FfDL's serving tier (phase 8e): a tenant's Pipeline whose train stage is a
# real tiny smollm-360m job, then a Service of the full-width engine, invoked
# at the serving phases' batch shape
SERVING_TENANT = "serving"
SERVING_STAGE = {"n_learners": 1, "chips_per_learner": 1, "arch": PLATFORM_ARCH,
                 "checkpoint_interval": 10,
                 "train": {"steps": 20, "batch": 4, "seq": 64, "seed": 3}}
SERVING_INVOKE = {"batch": 8, "prompt_len": 512, "gen": 32}
SERVING_INVOKES = (4, 2)  # invokes on one replica, then on two
# FfDL's wire (phase 8f): the same job and invoke over HTTP
WIRE_TENANT = "wire"
WIRE_INVOKES = 4
PIPELINE = ("DEPLOYING", "DOWNLOADING", "PROCESSING", "STORING")
# phase 8g: the port's examples, each main() with these arguments and
# --device cuda, in this order. train_e2e runs --quick (the tiny config, 150
# steps): at its default size (~100M, 300 steps) it took 280.7 s on the card,
# past what the script's limit leaves, and its loss did not fall (PERF.md)
EXAMPLES = (("quickstart", []), ("multi_tenant", []), ("multi_tenant", ["--http"]),
            ("pipeline_e2e", []), ("chaos_drill", []), ("train_e2e", ["--quick"]))
EXAMPLE_JOBS = {"quickstart": 40, "chaos_drill": 80, "train_e2e": 150}  # real-job steps
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)  # AdamW
TRAIN_TOL = 2e-2
# The same first step in fp32 (the fp32 routes of the flash forward and
# backward): only the order of the fp32 sums differs from the plain path.
# Read on the H100: loss 0 and grad norm 5.3e-6 apart; the bf16 step's gap,
# which an fp32 route computing in bf16 would show, is 2.4e-5 / 2.0e-4.
TRAIN_TOL_FP32 = 5e-5
# The RG-LRU scan's backward (csrc/rglru_bwd.cu) at recurrentgemma-2b's train
# shape: (B, S, W), fp32, no h0 (the train path's)
SCAN_BWD_MAIN = {"recurrentgemma train B8 S512": (8, 512, 2560)}
# recurrentgemma-2b's fp32 training at full width (phase 8's
# ``phase_train_fp32_d256``): the batch at TRAIN_SEQ is the largest whose
# dry-run peak leaves TRAIN_FP32_FREE of the card (``dryrun.HBM_BYTES``)
# free, searched from TRAIN_FP32_BATCH, the dry-run's answer on the CPU
# under torch 2.13 (B10: 70.65 GB; B11 73.4 GB). Its 2 timed steps' peak
# must be within DRYRUN_PEAK_TOL of the prediction.
RG_ARCH = "recurrentgemma-2b"
TRAIN_FP32_BATCH = 10
TRAIN_FP32_FREE = 0.10
# The same arch's tiny config in fp32 at head_dim 256 as a job through the
# port's platform (``phase_platform_fp32``): a job manifest's config
# overrides, the reference learner's too (src/repro/core/executor.py). Its
# per-tick losses on the card against the same job on the CPU, relative. At
# the learner's default lr of 3e-4 these 20 steps are chaotic: initial
# params moved by 1e-7 (relative) move step 19's loss by 2.17e-5 on the
# CPU, and the card read 3.27e-5 there; at 1e-4 a 1e-6 move shifts no tick
# by more than 4.29e-7, and a 10% error in attention's output gradient
# shifts step 14 by 1.50e-5 (benchmarks/torch_fp32_job_drift.py).
FP32_JOB = {"tiny": True, "overrides": {"dtype": "float32", "head_dim": 256}, "steps": 20,
            "batch": 4, "seq": 64, "seed": 3, "lr": 1e-4}
FP32_JOB_CKPT = 10
FP32_JOB_TOL = 1e-5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def qkv(gen, b, h, kv, sq, d, dtype, skv=None):
    skv = sq if skv is None else skv
    return (randn(gen, (b, h, sq, d), dtype), randn(gen, (b, kv, skv, d), dtype),
            randn(gen, (b, kv, skv, d), dtype))


def scan_inputs(gen, b, s, w, dtype, with_h0):
    """a in (0.79, 0.99) as the model's decays are, b ~ 0.1 N(0, 1)."""
    a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device="cuda")) * 0.2 + 0.79
    bb = 0.1 * torch.randn((b, s, w), generator=gen, device="cuda")
    h0 = torch.randn((b, w), generator=gen, device="cuda") if with_h0 else None
    return a.to(dtype), bb.to(dtype), h0


def max_err(out, want, tol=None):
    """(max |out - want|, whether |out - want| <= tol + tol*|want| holds)."""
    tol = TOL[want.dtype] if tol is None else tol
    diff = (out.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= tol + tol * want.float().abs()).all())


def outside_tol(out, want):
    """Elements of ``out`` outside TOL of ``want`` (the kernel-vs-plain rule)."""
    diff = (out.float() - want.float()).abs()
    tol = TOL[want.dtype]
    return int((diff > tol + tol * want.float().abs()).sum())


def attention_within(out, q, k, v, **kw):
    """(max |out - plain|, elements outside TOL + P_ROUNDING (softmax.|V|)):
    the bf16 route's bound against the plain version, whose probabilities
    stay fp32."""
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    p_abs_v = ref.flash_attention_ref(q, k, v.abs(), **kw).float()  # softmax . |V|
    diff = (out.float() - want).abs()
    tol = TOL[q.dtype]
    return diff.max().item(), int((diff > tol + tol * want.abs() + P_ROUNDING * p_abs_v).sum())


def device_ms(fn, iters=50, replays=5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events. The host's launch
    overhead, tens of microseconds a call through Python on this machine
    and as long as a whole short kernel, is left out (``time_ms`` keeps it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (replays * iters)


def time_ms(fn, iters=50, warmup=5) -> float:
    """Time of one eager call of ``fn``, host included: ``iters`` calls
    back to back between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, kind):
    """Least time on the card: the larger of the bytes over HBM bandwidth
    and the operations over the peak rate for their type (``kind``, a key
    of PEAK_FLOPS)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def unmasked_pairs(sq, skv, causal, window, q_offset=0) -> int:
    """(query, key) pairs that the masks keep, per (batch, head)."""
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq, int)
    return int(np.clip(hi - lo, 0, None).sum())


def attention_bound(b, h, kv, sq, d, causal, window, dtype, skv=None, q_offset=0):
    """q, k, v read once, o written once; 2 products of 2 FLOP per unmasked
    (query, key) pair and head dim. bf16 runs them on the tensor cores; the
    fp32 route runs each as SPLIT_TF32_PRODUCTS TF32 products, and its row
    also gives the bound of the same work on the fp32 CUDA cores."""
    skv = sq if skv is None else skv
    pairs = unmasked_pairs(sq, skv, causal, window, q_offset)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * sq * d + 2 * b * kv * skv * d) * itemsize
    flops = 4 * d * pairs * b * h
    if dtype == torch.bfloat16:
        return bound(nbytes, flops, "bf16")
    cuda_cores = bound(nbytes, flops, "fp32")
    return {**bound(nbytes, SPLIT_TF32_PRODUCTS * flops, "tf32"),
            "cuda_core_bound_ms": cuda_cores["bound_ms"],
            "cuda_core_bound_by": cuda_cores["bound_by"]}


def attention_bwd_bound(b, h, kv, sq, d, causal, window, dtype, skv=None, q_offset=0):
    """The backward: q, o, do and dq (B, H, Sq, D), k, v, dk and dv (B, KV,
    Skv, D) once each and the fp32 lse; 5 products (S, dP, dV, dQ, dK) of
    2·D FLOP per unmasked (query, key) pair and head. As in attention_bound:
    bf16 on the tensor cores, fp32 as SPLIT_TF32_PRODUCTS TF32 products
    each, with the bound of the same work on the fp32 CUDA cores beside it."""
    skv = sq if skv is None else skv
    pairs = unmasked_pairs(sq, skv, causal, window, q_offset)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (4 * b * h * sq * d + 4 * b * kv * skv * d) * itemsize + 4 * b * h * sq
    flops = 10 * d * pairs * b * h
    if dtype == torch.bfloat16:
        return bound(nbytes, flops, "bf16")
    cuda_cores = bound(nbytes, flops, "fp32")
    return {**bound(nbytes, SPLIT_TF32_PRODUCTS * flops, "tf32"),
            "cuda_core_bound_ms": cuda_cores["bound_ms"],
            "cuda_core_bound_by": cuda_cores["bound_by"]}


def scan_bound(b, s, w, dtype):
    """a, b read once, h written once, h_last (fp32) written once; one FMA
    (2 FLOP, fp32) per element."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return bound(3 * b * s * w * itemsize + 4 * b * w, 2 * b * s * w, "fp32")


def window_mask(s, window, device):
    """Boolean mask (True = attend) of causal attention within ``window``."""
    pos = torch.arange(s, device=device)
    diff = pos[:, None] - pos[None, :]
    return (diff >= 0) & (diff < window)


def phase_build(failures):
    names = [p.stem for p in sorted(_build.CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    _build.build(names)
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name in names:
        for line in _build.log_path(name).read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill", "serialized",
                                       "setmaxnreg")):
                print(f"  ptxas {name}: {line.strip()}")
            spills = re.findall(r"(\d+) bytes spill", line)
            if any(int(n) for n in spills) or "serialized" in line:
                failures.append(f"ptxas {name}: {line.strip()}")
    if not names:
        failures.append("no kernel sources found")
    print("  rglru (cuda) dynamic shared memory per block: " + ", ".join(
        f"{str(dt).split('.')[-1]}: {scan_smem_bytes(dt)} B" for dt in (torch.float32, torch.bfloat16))
        + f"; its backward rglru_bwd (fp32): {scan_bwd_smem_bytes()} B")
    # both routes of the forward and of the backward must reach the tensor cores
    for lib, want in ((ROUTES[torch.bfloat16][0], ("HGMMA",)),
                      (ROUTES[torch.float32][0], ("TF32",)),
                      (BWD_ROUTES[torch.bfloat16][0], ("HGMMA",)),
                      (BWD_ROUTES[torch.float32][0], ("TF32",))):
        sass = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
                               str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        # tensor-core instructions, and among them those on the route's operands
        mma = [line for line in sass.splitlines() if "HGMMA" in line or "HMMA" in line]
        n = sum(all(w in line for w in want) for line in mma)
        print(f"  {lib} SASS: {len(mma)} tensor-core instructions (HMMA/HGMMA), {n} of them "
              f"{'/'.join(want)} (cuobjdump -sass)")
        if not n:
            failures.append(f"{lib}: no {'/'.join(want)} tensor-core instruction in its SASS")
    for dtype, (source, route) in ROUTES.items():
        print(f"  {source} ({route}, {str(dtype).split('.')[-1]}) dynamic shared memory per "
              "block: " + ", ".join(f"D={d}: {smem_bytes(d, dtype)} B" for d in HEAD_DIMS))
    for dtype, (source, route) in BWD_ROUTES.items():
        print(f"  {source} ({route}, {str(dtype).split('.')[-1]}) dynamic shared memory per "
              "block (the larger tile kernel): "
              + ", ".join(f"D={d}: {bwd_smem_bytes(d, dtype)} B" for d in HEAD_DIMS))
        over = [d for d in HEAD_DIMS if not 0 < bwd_smem_bytes(d, dtype) <= BLOCK_SMEM_BYTES]
        if over:
            failures.append(f"{source}: shared memory a block past {BLOCK_SMEM_BYTES} B at "
                            f"head_dim {over}")


def flash_row(q, k, v, kw, err, library, route, shape):
    """Times of the kernel, the plain version and ``library`` on one input,
    beside the bound; printed, and returned as a row of the kernels line."""
    b, h, sq, d = q.shape
    kernel = lambda: ops.flash_attention(q, k, v, force="kernel", **kw)  # noqa: E731
    row = {"shape": shape, "route": route, "max_abs_err": err,
           "ms": device_ms(kernel), "eager_ms": time_ms(kernel),
           "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=5),
           "library_ms": device_ms(library), "eager_library_ms": time_ms(library),
           **attention_bound(b, h, k.shape[1], sq, d, kw["causal"], kw["window"], q.dtype)}
    ops_kind = "split-TF32 " if "cuda_core_bound_ms" in row else ""
    cuda_cores = (f", fp32 CUDA-core bound {row['cuda_core_bound_ms']:.4f} ms "
                  f"({row['cuda_core_bound_by']}), kernel/that bound "
                  f"{row['ms'] / row['cuda_core_bound_ms']:.2f}" if ops_kind else "")
    print(f"flash {shape} [{route}]: kernel {row['ms']:.4f} ms (eager {row['eager_ms']:.4f}), "
          f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms (eager "
          f"{row['eager_library_ms']:.4f}), {ops_kind}bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {row['flops'] / 1e9:.2f} {ops_kind}GFLOP, "
          f"{row['bytes'] / 1e6:.2f} MB), kernel/bound {row['ms'] / row['bound_ms']:.2f}"
          f"{cuda_cores}; kernel/sdpa {row['ms'] / row['library_ms']:.2f} "
          f"(eager {row['eager_ms'] / row['eager_library_ms']:.2f})")
    return row


def phase_flash(failures):
    """The flash kernel against its plain version; times at the main paths'
    shapes. Returns ({dtype: {label: timed row}}, {dtype: worst error})."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def check(label, q, k, v, want, **kw):
        out = ops.flash_attention(q, k, v, force="kernel", **kw)
        torch.cuda.synchronize()
        err, ok = max_err(out, want)
        worst[q.dtype] = max(worst[q.dtype], err)
        print(f"case flash {label}: max_abs_err={err:.3e} tol={TOL[q.dtype]:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention {label}: max_abs_err {err:.3e}")
        return err

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for b, h, kv, s, d, causal, window in FLASH_CASES + EXTRA_CASES:
            q, k, v = qkv(gen, b, h, kv, s, d, dtype)
            check(f"B{b} H{h} KV{kv} S{s} D{d} causal={causal} window={window} {dt}",
                  q, k, v, ref.flash_attention_ref(q, k, v, causal=causal, window=window),
                  causal=causal, window=window)
        # q as a suffix of the kv sequence (tests/test_kernels.py:60)
        q, k, v = qkv(gen, 1, 4, 4, 256, 64, dtype)
        full = ref.flash_attention_ref(q, k, v, causal=True)
        check(f"q_offset suffix S256 last64 {dt}", q[:, :, -64:].contiguous(), k, v,
              full[:, :, -64:], causal=True, q_offset=192)
        # ragged Sq != Skv with an offset and a window
        q, k, v = qkv(gen, 2, 6, 2, 100, 64, dtype, skv=300)
        check(f"Sq100 Skv300 q_offset=200 window=96 {dt}", q, k, v,
              ref.flash_attention_ref(q, k, v, causal=True, window=96, q_offset=200),
              causal=True, window=96, q_offset=200)
    # bf16 at every head dim, lengths no tile divides (the wgmma route's
    # ragged tails, 3-D TMA boxes and offsets)
    for d in HEAD_DIMS:
        q, k, v = qkv(gen, 1, 4, 2, 1000, d, torch.bfloat16)
        check(f"ragged B1 H4 KV2 S1000 D{d} causal bfloat16", q, k, v,
              ref.flash_attention_ref(q, k, v, causal=True), causal=True)
        q, k, v = qkv(gen, 2, 6, 1, 100, d, torch.bfloat16, skv=300)
        kw = dict(causal=True, window=96, q_offset=200)
        check(f"ragged B2 H6 KV1 Sq100 Skv300 q_offset=200 window=96 D{d} bfloat16",
              q, k, v, ref.flash_attention_ref(q, k, v, **kw), **kw)
    # a contiguous view that starts 2 bytes past an aligned pointer
    q, k, v = qkv(gen, 1, 2, 1, 128, 64, torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)[1:].view(q.shape)
    shifted.copy_(q)
    before = ops.launch_counts()["flash_attention"]
    raised = True
    with contextlib.suppress(ValueError):  # the outcome this case wants
        ops.flash_attention(shifted, k, v, force="kernel")
        raised = False
    ok = raised and ops.launch_counts()["flash_attention"] == before
    print(f"case flash misaligned view (storage offset 1, contiguous): "
          f"{'ValueError' if raised else 'no ValueError'}, launches unchanged "
          f"{ops.launch_counts()['flash_attention'] == before} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("flash_attention: a misaligned view did not raise ValueError")

    # Each route at the shapes its main path gives it: bf16 at the serving
    # paths' four, fp32 at the two of the fp32 logits checks (SDPA in fp32
    # with TF32 off, as main() sets it).
    timings = {torch.bfloat16: {}, torch.float32: {}}
    for dtype, labels in ((torch.bfloat16, FLASH_MAIN), (torch.float32, FLASH_FP32)):
        dt = str(dtype).split(".")[-1]
        for label in labels:
            b, h, kv, s, d, causal, window = FLASH_MAIN[label]
            q, k, v = qkv(gen, b, h, kv, s, d, dtype)
            kw = dict(causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = check(f"main path {label} H{h} KV{kv} D{d} window={window} {dt}",
                        q, k, v, want, **kw)
            del want
            first, second = (ops.flash_attention(q, k, v, force="kernel", **kw)
                             for _ in range(2))
            same = torch.equal(first, second)
            print(f"case flash determinism {label} {dt}: two launches "
                  f"{'equal bit for bit' if same else 'DIFFER'}")
            if not same:
                failures.append(f"flash_attention {label} {dt}: two launches differ")
            del first, second
            if window and window < s:
                mask = window_mask(s, window, q.device)
                library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=mask, enable_gqa=True)
            else:
                library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal, enable_gqa=True)
            timings[dtype][label] = flash_row(
                q, k, v, kw, err, library, ROUTES[dtype][1],
                f"B{b} H{h} KV{kv} S{s} D{d} {'bf16' if dt == 'bfloat16' else 'fp32'} "
                f"{'causal' if causal else 'bidirectional'} window={window}")
    for dtype, err in worst.items():
        print(f"flash_attention {str(dtype).split('.')[-1]}: worst max_abs_err over all cases "
              f"{err:.3e} (tol {TOL[dtype]:g})")
    return timings, worst


def grad_inputs(gen, b, h, kv, sq, skv, d, dtype):
    q, k, v = qkv(gen, b, h, kv, sq, d, dtype, skv=skv)
    return q, k, v, randn(gen, (b, h, sq, d), dtype)


def device_split(fn, iters=10, replays=3) -> tuple[dict, dict]:
    """Device time of one call of ``fn`` by kernel, from the profiler:
    ``iters`` calls captured in a CUDA graph and replayed ``replays`` times
    under torch.profiler, each kernel execution counted once (by name and
    start). Kineto drops a session's first GPU records (ROADMAP C.12), so
    the session opens with a CUDA operation and one replay of its own (a
    CUDA operation alone still lost 2 of 30 executions once), and only the
    records that start inside the replays' span count. Returns
    ({kernel name as in the source: ms a call}, {kernel name: executions
    the profiler saw a call})."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").sum().item()  # the session's first records
        graph.replay()
        torch.cuda.synchronize()
        with record_function("replays"):
            for _ in range(replays):
                graph.replay()
            torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    events = prof.events()
    start = [e for e in events
             if e.name == "replays" and e.device_type == DeviceType.CPU][0].time_range.start
    runs = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name != "replays" \
                and e.time_range.start >= start:
            found = BWD_KERNEL.search(e.name)
            name = found.group(0) if found else e.name[:40]
            runs.setdefault(name, {})[e.time_range.start] = e.time_range.elapsed_us()
    calls = iters * replays
    return ({name: sum(r.values()) / 1e3 / calls for name, r in runs.items()},
            {name: len(r) / calls for name, r in runs.items()})


def phase_flash_bwd(failures):
    """The attention backward kernel against its plain version (given the
    same o and lse) on both routes, head_dim 16 to 256, the forward's lse
    against the plain forward's, two launches bit-equal; a misaligned bf16
    view raises. Then times at the train paths' shapes (smollm's D64,
    recurrentgemma's D256) beside SDPA's backward, split by kernel, and the
    fp32 route's at smollm's and recurrentgemma's S512.
    Returns ({dtype: {label: timed row}}, {dtype: worst max_abs_err})."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {dtype: {"abs": 0.0, "rel": 0.0} for dtype in BWD_ROUTES}

    def check(label, q, k, v, do, **kw):
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        _, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        lse_err, lse_ok = max_err(lse, want_lse, LSE_TOL)
        err = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        rel = [e / max(w.float().abs().max().item(), 1e-30) for e, w in zip(err, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = lse_ok and max(rel) <= BWD_TOL[q.dtype] and same and \
            all(g.dtype == q.dtype for g in got)
        w = worst[q.dtype]
        w["abs"], w["rel"] = max(w["abs"], *err), max(w["rel"], *rel)
        print(f"case flash_bwd {label} [{BWD_ROUTES[q.dtype][1]}]: dq/dk/dv max_abs_err "
              f"{err[0]:.2e}/{err[1]:.2e}/{err[2]:.2e}, over max|grad| {rel[0]:.2e}/"
              f"{rel[1]:.2e}/{rel[2]:.2e} tol={BWD_TOL[q.dtype]:g}, lse "
              f"max_abs_err={lse_err:.2e} tol={LSE_TOL:g}, two launches "
              f"{'equal bit for bit' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention_bwd {label}: relative errors {rel}, lse "
                            f"{lse_err:.2e}, bit-equal {same}")
        return max(err)

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for b, h, kv, sq, skv, d, causal, window, q_offset in BWD_CASES + BWD_CASES_D256:
            check(f"B{b} H{h} KV{kv} Sq{sq} Skv{skv} D{d} causal={causal} window={window} "
                  f"q_offset={q_offset} {dt}", *grad_inputs(gen, b, h, kv, sq, skv, d, dtype),
                  causal=causal, window=window, q_offset=q_offset)
    # the bf16 route's TMA loads need do (and o) 16-byte aligned: a contiguous
    # view 2 bytes past an aligned pointer raises and launches nothing
    q, k, v, do = grad_inputs(gen, 1, 2, 1, 128, 128, 64, torch.bfloat16)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    shifted = torch.empty(do.numel() + 1, dtype=do.dtype, device=do.device)[1:].view(do.shape)
    shifted.copy_(do)
    before = ops.launch_counts()["flash_attention_bwd"]
    raised = True
    with contextlib.suppress(ValueError):  # the outcome this case wants
        flash_attention_bwd_cuda(q, k, v, o, shifted, lse)
        raised = False
    ok = raised and ops.launch_counts()["flash_attention_bwd"] == before
    print(f"case flash_bwd misaligned do view (storage offset 1, contiguous, bf16): "
          f"{'ValueError' if raised else 'no ValueError'}, launches unchanged "
          f"{ops.launch_counts()['flash_attention_bwd'] == before} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("flash_attention_bwd: a misaligned bf16 do view did not raise ValueError")

    timings = {torch.bfloat16: {}, torch.float32: {}}
    mains = [(label, shape, torch.bfloat16) for label, shape in BWD_MAIN.items()]
    mains += [(label, BWD_MAIN[label], torch.float32) for label in BWD_FP32]  # SDPA: TF32 off
    for label, (b, h, kv, s, d, causal), dtype in mains:
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do = grad_inputs(gen, b, h, kv, s, s, d, dtype)
        err = check(f"main path {label} H{h} KV{kv} D{d} {dt}", q, k, v, do, causal=causal)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, causal=causal)
        kernel = lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)  # noqa: E731
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            *leaves, is_causal=causal, enable_gqa=True)
        sdpa_fwd_bwd = lambda: torch.autograd.grad(sdpa(), leaves, do)  # noqa: E731
        iters = 10 if s > 1024 or dtype == torch.float32 else 50
        row = {"shape": f"B{b} H{h} KV{kv} S{s} D{d} {dt} "
                        f"{'causal' if causal else 'bidirectional'}", "route": "cuda",
               "max_abs_err": err, "ms": device_ms(kernel, iters=iters),
               "eager_ms": time_ms(kernel, iters=iters),
               "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                                       causal=causal),
                                   iters=3, warmup=1),
               "sdpa_fwd_ms": device_ms(sdpa, iters=iters),
               "sdpa_fwd_bwd_ms": device_ms(sdpa_fwd_bwd, iters=iters),
               **attention_bwd_bound(b, h, kv, s, d, causal, 0, dtype)}
        row["library_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
        # Kineto now and then drops kernel records inside a session too
        # (ROADMAP C.12): a session in which each of the 3 kernels shows up
        # and none more than once a call, but some less, lost records and is
        # taken again, up to SPLIT_SESSIONS. A kernel missing from a session
        # or seen more than once a call fails at once. Every session's
        # counts go into the kernels line.
        row["split_sessions"] = []
        for _ in range(SPLIT_SESSIONS):
            row["kernel_split_ms"], runs = device_split(kernel)
            row["split_sessions"].append(runs)
            if len(runs) != 3 or max(runs.values()) > 1 or min(runs.values()) == 1:
                break
        if len(runs) != 3 or set(runs.values()) != {1}:
            failures.append(f"flash_attention_bwd {label}: the profiler saw "
                            f"{row['split_sessions']} executions of each kernel a call, "
                            "session by session, want 3 kernels once each")
        ops_kind = "split-TF32 " if "cuda_core_bound_ms" in row else ""
        print(f"flash_bwd {label} ({row['shape']}, {BWD_ROUTES[dtype][0]}): kernel "
              f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}), plain {row['plain_ms']:.4f} "
              f"ms, sdpa backward {row['library_ms']:.4f} ms (fwd+bwd "
              f"{row['sdpa_fwd_bwd_ms']:.4f} - fwd {row['sdpa_fwd_ms']:.4f}), {ops_kind}bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {row['flops'] / 1e9:.2f} "
              f"{ops_kind}GFLOP, "
              f"{row['bytes'] / 1e6:.2f} MB), kernel/bound {row['ms'] / row['bound_ms']:.1f}, "
              + (f"fp32 CUDA-core bound {row['cuda_core_bound_ms']:.4f} ms "
                 f"({row['cuda_core_bound_by']}), kernel/that bound "
                 f"{row['ms'] / row['cuda_core_bound_ms']:.1f}, "
                 if "cuda_core_bound_ms" in row else "")
              + f"kernel/sdpa backward {row['ms'] / row['library_ms']:.2f}; by kernel (profiler "
              f"over the replayed graph, executions a call {runs}): "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in row["kernel_split_ms"].items()))
        timings[dtype][label] = row
        del leaves
    for dtype, w in worst.items():
        print(f"flash_attention_bwd {str(dtype).split('.')[-1]} ({BWD_ROUTES[dtype][0]}): worst "
              f"over all cases max_abs_err {w['abs']:.3e}, max_abs_err/max|grad| {w['rel']:.3e}")
    return timings, {dtype: w["abs"] for dtype, w in worst.items()}


def phase_grad_mode(failures):
    """With grad on: a flash output on the card carries FlashAttentionFn as
    its grad_fn and a scan output RGLRUScanFn; an fp32 flash output at
    head_dim 256 (recurrentgemma's) launches the fp32 backward once, its
    gradients within BWD_TOL of the plain backward's. Each kernel that
    encodes TMA descriptors launches from a new thread with the main
    thread's bits."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (t.requires_grad_(True) for t in qkv(gen, 1, 4, 2, 128, 64, torch.bfloat16))
    out = ops.flash_attention(q, k, v)
    name = type(out.grad_fn).__name__
    ok = name == "FlashAttentionFnBackward"
    print(f"case grad mode: flash output grad_fn {name} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flash_attention under grad: grad_fn {name}, want FlashAttentionFn")
    a, bb, _ = scan_inputs(gen, 2, 64, 128, torch.float32, False)
    a.requires_grad_(True)
    h, _ = ops.rglru_scan(a, bb)
    name = type(h.grad_fn).__name__
    ok = name == "RGLRUScanFnBackward"
    print(f"case grad mode: rglru scan output grad_fn {name} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"rglru_scan under grad: grad_fn {name}, want RGLRUScanFn")
    q, k, v, do = grad_inputs(gen, 1, 2, 1, 64, 64, 256, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()["flash_attention_bwd"]
    out = ops.flash_attention(*leaves)
    name = type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    launched = ops.launch_counts()["flash_attention_bwd"] - before
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    rel = max((g - w).abs().max().item() / w.abs().max().item() for g, w in zip(got, want))
    ok = name == "FlashAttentionFnBackward" and launched == 1 and \
        rel <= BWD_TOL[torch.float32]
    print(f"case grad mode: fp32 flash at head_dim 256: grad_fn {name}, {launched} backward "
          f"launch(es), gradients within {rel:.2e} of max|grad| of the plain ones (tol "
          f"{BWD_TOL[torch.float32]:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flash_attention under grad, fp32 D256: grad_fn {name}, {launched} "
                        f"backward launches, relative error {rel:.2e}")
    # a thread whose first CUDA call is a TMA kernel's launch (autograd's
    # device thread can be one): the same bits as on the main thread
    a, bb, _ = scan_inputs(gen, 2, 100, 64, torch.float32, False)
    h, _ = ref.rglru_scan_ref(a, bb)
    q, k, v = qkv(gen, 1, 4, 2, 128, 64, torch.bfloat16)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    launches = {"rglru_scan": lambda: rglru_scan_cuda(a, bb),
                "rglru_scan_bwd": lambda: rglru_scan_bwd_cuda(a, h, bb)[:2],
                "flash_attention bf16": lambda: (flash_attention_cuda(q, k, v),),
                "flash_attention_bwd bf16": lambda: flash_attention_bwd_cuda(q, k, v, o, q, lse)}
    for name, launch in launches.items():
        # a pool of one new thread; a launch that raises there raises here
        with ThreadPoolExecutor(max_workers=1) as pool:
            out = pool.submit(lambda launch=launch: (launch(), torch.cuda.synchronize())[0]
                              ).result(timeout=120)
        ok = all(torch.equal(x, y) for x, y in zip(out, launch()))
        print(f"case {name} launched from a new thread: "
              f"{'the main thread' if ok else 'NOT the main thread'}'s bits {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} from a new thread: bits differ from the main thread's")


def phase_rglru(failures):
    """The RG-LRU scan kernel against its plain version, within SCAN_TOL and
    bit for bit; times at the main path's shapes (no PyTorch call computes
    a linear recurrence: no library time)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0

    def check(label, a, b, h0):
        nonlocal worst
        h, h_last = ops.rglru_scan(a, b, h0, force="kernel")
        want, want_last = ref.rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        tol = SCAN_TOL[a.dtype]
        err, ok = max_err(h, want, tol)
        err_last, ok_last = max_err(h_last, want_last, tol)
        equal = torch.equal(h, want) and torch.equal(h_last, want_last)
        ok = ok and ok_last and equal and h.dtype == b.dtype and h_last.dtype == torch.float32
        err = max(err, err_last)
        worst = max(worst, err)
        print(f"case rglru {label} [loads: {'tma' if uses_tma(a, b) else 'ld/st'}]: "
              f"max_abs_err={err:.3e} tol={tol:g} bit-equal={equal} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"rglru_scan {label}: max_abs_err {err:.3e}, bit-equal {equal}")
        return err

    for b, s, w in RGLRU_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                check(f"B{b} S{s} W{w} {str(dtype).split('.')[-1]} h0={with_h0}",
                      *scan_inputs(gen, b, s, w, dtype, with_h0))
    for dtype in (torch.float32, torch.bfloat16):
        a, bb, h0 = scan_inputs(gen, 2, 300, 96, dtype, True)
        a[..., 0::3], a[..., 1::3] = 0.0, 1.0
        check(f"B2 S300 W96 {str(dtype).split('.')[-1]} h0=True, a exactly 0 and 1 on two "
              "lanes in three", a, bb, h0)
    # a contiguous view that starts 4 bytes past an aligned pointer
    a, bb, h0 = scan_inputs(gen, 2, 300, 96, torch.float32, True)
    shifted = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:].view(a.shape)
    shifted.copy_(a)
    check("B2 S300 W96 float32 h0=True, a a view at storage offset 1", shifted, bb, h0)

    timings = {}
    for label, (b, s, w) in RGLRU_MAIN.items():
        a, bb, _ = scan_inputs(gen, b, s, w, torch.float32, False)
        err = check(f"main path {label} W{w} float32 h0=False", a, bb, None)
        first, second = (ops.rglru_scan(a, bb, force="kernel") for _ in range(2))
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        print(f"case rglru determinism {label}: two launches "
              f"{'equal bit for bit' if same else 'DIFFER'}")
        if not same:
            failures.append(f"rglru_scan {label}: two launches differ")
        del first, second
        out = torch.empty_like(bb)
        row = {"shape": f"B{b} S{s} W{w} fp32, no h0", "route": "cuda", "max_abs_err": err,
               "ms": device_ms(lambda: ops.rglru_scan(a, bb, force="kernel")),
               "eager_ms": time_ms(lambda: ops.rglru_scan(a, bb, force="kernel")),
               "plain_ms": time_ms(lambda: ref.rglru_scan_ref(a, bb), iters=3, warmup=1),
               "library_ms": None,
               "same_bytes_add_ms": device_ms(lambda: torch.add(a, bb, out=out)),
               **scan_bound(b, s, w, torch.float32)}
        row["gb_s"] = row["bytes"] / row["ms"] / 1e6
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(f"rglru {label} ({row['shape']}): kernel {row['ms']:.4f} ms (eager "
              f"{row['eager_ms']:.4f}), {row['gb_s']:.0f} GB/s, {100 * row['share_of_bound']:.1f}% "
              f"of the bound; plain {row['plain_ms']:.4f} ms, library none, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {row['bytes'] / 1e6:.2f} MB); "
              f"torch.add a + b -> h (the same bytes) {row['same_bytes_add_ms']:.4f} ms "
              f"({3 * a.numel() * 4 / row['same_bytes_add_ms'] / 1e6:.0f} GB/s)")
        timings[label] = row
    print(f"rglru_scan: worst max_abs_err over all cases {worst:.3e}")
    return timings, worst


def scan_bwd_bound(b, s, w):
    """a, h and g read once, da and db written once, fp32; 3 FLOP an
    element (the carry's product, the add, da's product)."""
    return bound(5 * b * s * w * 4, 3 * b * s * w, "fp32")


def phase_rglru_bwd(failures):
    """The scan's backward kernel (csrc/rglru_bwd.cu) against its plain
    version, bit for bit, over the forward's edge cases, each with and
    without h0 and h_last's gradient, exact a = 0 and a = 1, a view off 16
    bytes; two launches bit-equal at the train shape; its time there beside
    the bound and an elementwise yardstick (no PyTorch call computes a
    reverse recurrence: no library time)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0

    def check(label, a, h, g, h0, g_last):
        nonlocal worst
        got = rglru_scan_bwd_cuda(a, h, g, h0, g_last)
        want = ref.rglru_scan_bwd_ref(a, h, g, h0, g_last)
        torch.cuda.synchronize()
        equal = all((x is None and y is None) or (x is not None and y is not None
                                                  and torch.equal(x, y))
                    for x, y in zip(got, want))
        err = max((x - y).abs().max().item() for x, y in zip(got, want) if x is not None)
        worst = max(worst, err)
        print(f"case rglru_bwd {label} [loads: {'tma' if bwd_uses_tma(a, h, g) else 'ld/st'}]: "
              f"max_abs_err={err:.3e} bit-equal={equal} {'ok' if equal else 'FAIL'}")
        if not equal:
            failures.append(f"rglru_scan_bwd {label}: max_abs_err {err:.3e}, not bit-equal")
        return err

    def inputs(b, s, w, with_h0, with_gl):
        a, bb, h0 = scan_inputs(gen, b, s, w, torch.float32, with_h0)
        h, _ = ref.rglru_scan_ref(a, bb, h0)
        g = torch.randn((b, s, w), generator=gen, device="cuda")
        g_last = torch.randn((b, w), generator=gen, device="cuda") if with_gl else None
        return a, h, g, h0, g_last

    for b, s, w in RGLRU_CASES:
        for with_h0 in (False, True):
            for with_gl in (False, True):
                check(f"B{b} S{s} W{w} h0={with_h0} g_last={with_gl}",
                      *inputs(b, s, w, with_h0, with_gl))
    a, h, g, h0, g_last = inputs(2, 300, 96, True, True)
    a[..., 0::3], a[..., 1::3] = 0.0, 1.0
    h, _ = ref.rglru_scan_ref(a, torch.randn_like(a), h0)
    check("B2 S300 W96 h0=True g_last=True, a exactly 0 and 1 on two lanes in three",
          a, h, g, h0, g_last)
    a, h, g, h0, g_last = inputs(2, 300, 96, True, False)
    shifted = torch.empty(g.numel() + 1, dtype=g.dtype, device=g.device)[1:].view(g.shape)
    shifted.copy_(g)
    check("B2 S300 W96 h0=True, g a view at storage offset 1", a, h, shifted, h0, None)

    timings = {}
    for label, (b, s, w) in SCAN_BWD_MAIN.items():
        a, h, g, _, _ = inputs(b, s, w, False, False)
        err = check(f"main path {label} W{w} fp32 h0=False g_last=False", a, h, g, None, None)
        first, second = (rglru_scan_bwd_cuda(a, h, g) for _ in range(2))
        same = all(torch.equal(x, y) for x, y in zip(first[:2], second[:2]))
        print(f"case rglru_bwd determinism {label}: two launches "
              f"{'equal bit for bit' if same else 'DIFFER'}")
        if not same:
            failures.append(f"rglru_scan_bwd {label}: two launches differ")
        del first, second
        out = torch.empty_like(a)
        kernel = lambda: rglru_scan_bwd_cuda(a, h, g)  # noqa: E731
        yard = lambda: torch.addcmul(a, h, g, out=out)  # noqa: E731
        row = {"shape": f"B{b} S{s} W{w} fp32, no h0", "route": "cuda", "max_abs_err": err,
               "ms": device_ms(kernel), "eager_ms": time_ms(kernel),
               "plain_ms": time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, g), iters=3, warmup=1),
               "library_ms": None, "yardstick_addcmul_ms": device_ms(yard),
               **scan_bwd_bound(b, s, w)}
        row["gb_s"] = row["bytes"] / row["ms"] / 1e6
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        yard_bytes = 4 * a.numel() * 4
        print(f"rglru_bwd {label} ({row['shape']}): kernel {row['ms']:.4f} ms (eager "
              f"{row['eager_ms']:.4f}), {row['gb_s']:.0f} GB/s, "
              f"{100 * row['share_of_bound']:.1f}% of the bound; plain {row['plain_ms']:.4f} ms, "
              f"library none, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bytes'] / 1e6:.2f} MB); yardstick torch.addcmul(a, h, g) (3 reads, 1 "
              f"write, {yard_bytes / 1e6:.2f} MB) {row['yardstick_addcmul_ms']:.4f} ms "
              f"({yard_bytes / row['yardstick_addcmul_ms'] / 1e6:.0f} GB/s)")
        timings[label] = row
    print(f"rglru_scan_bwd: worst max_abs_err over all cases {worst:.3e} (bit-equal required)")
    return timings, worst


# --------------------------------------------------------------------------
# the main paths at full width
# --------------------------------------------------------------------------

def serve(arch, generates, failures):
    """Build the full-width engine, then the main path with the launch
    counts set to 0 just before and read just after: the 3 ``infer``
    requests and each (B, S, gen) of ``generates``. Returns the engine,
    the launches, the prompts of each generate and its metrics."""
    t0 = time.perf_counter()
    engine = ServeEngine(arch, tiny=False, seed=0, device="cuda")
    cfg = engine.cfg
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_flatten_with_paths(engine.params))
    kinds = cfg.pattern_for_layers()
    print(f"engine: {cfg.name} {cfg.n_layers} layers ("
          + ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
          + f"), d_model={cfg.d_model} head_dim={cfg.hd} stacked={cfg.scan_layers} "
          f"params={n_params:,} built in {time.perf_counter() - t0:.1f} s")
    prompts = [engine.synthetic_prompts(b, s) for b, s, _ in generates]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    answers = [engine.infer(p) for p in INFER_PAYLOADS]
    outs = [engine.generate(pr, gen) for pr, (_, _, gen) in zip(prompts, generates)]
    launches = ops.launch_counts()

    for p, a in zip(INFER_PAYLOADS, answers):
        n = max(2, int(p.get("gen", 8)))
        if len(a["tokens"]) != n or not all(0 <= t < cfg.vocab_size for t in a["tokens"]):
            failures.append(f"{arch} infer {p}: bad tokens {a['tokens']}")
    metrics = {"peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    for (b, s, gen), out in zip(generates, outs):
        toks = out["tokens"]
        if tuple(toks.shape) != (b, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            failures.append(f"{arch} generate: tokens of shape {tuple(toks.shape)} out of range")
        key = f"B{b} S{s}"
        m = metrics[key] = {"decode_ms_per_token": out["decode_s"] / (gen - 1) * 1e3,
                            "decode_tok_s": b * (gen - 1) / out["decode_s"]}
        prefill = ""
        if out["prefill_s"]:  # an encoder-decoder's generate encodes instead
            m.update(prefill_tok_s=b * s / out["prefill_s"], prefill_ms=out["prefill_s"] * 1e3)
            prefill = f"prefill {m['prefill_tok_s']:,.0f} tok/s ({m['prefill_ms']:.2f} ms), "
        print(f"{arch} generate B={b} prompt={s} gen={gen}: {prefill}decode "
              f"{m['decode_ms_per_token']:.3f} ms/token ({m['decode_tok_s']:,.0f} tok/s); "
              f"sample {toks[0, :8].tolist()}")
    print(f"{arch} peak device memory over the main path {metrics['peak_mem_gib']:.2f} GiB")
    return engine, launches, [p.cuda() for p in prompts], metrics


def expect_launches(arch, launches, want, failures):
    print(f"{arch} launches on the main path: {launches}, expected {want}")
    for name, n in want.items():
        if launches[name] != n:
            failures.append(f"{arch}: {name} launched {launches[name]} times, want {n}")


def phase_smollm(failures):
    """smollm-360m's serving path, stacked layout, flash kernel only."""
    generates = [(8, 512, 32)]
    engine, launches, prompts, metrics = serve("smollm-360m", generates, failures)
    n_prefills = len(INFER_PAYLOADS) + len(generates)
    expect_launches("smollm-360m", launches,
                    {"flash_attention": engine.cfg.n_layers * n_prefills,
                     "rglru_scan": 0, "rglru_scan_bwd": 0}, failures)
    metrics.update(check_per_layer(engine, prompts[0], failures))
    logits, fp32_launches = check_logits(engine.cfg, engine.params, prompts[0], failures)
    metrics.update(logits)
    return launches, fp32_launches, metrics


def phase_recurrentgemma(failures):
    """recurrentgemma-2b's serving path, list layout, both kernels."""
    generates = [(8, 512, 32), (1, 3072, 8)]
    engine, launches, prompts, metrics = serve("recurrentgemma-2b", generates, failures)
    kinds = engine.cfg.pattern_for_layers()
    n_prefills = len(INFER_PAYLOADS) + len(generates)
    expect_launches("recurrentgemma-2b", launches,
                    {"flash_attention": kinds.count("attn") * n_prefills,
                     "rglru_scan": kinds.count("rglru") * n_prefills, "rglru_scan_bwd": 0},
                    failures)
    for tokens in prompts:
        metrics.update(check_per_layer(engine, tokens, failures))
    logits, fp32_launches = check_logits(engine.cfg, engine.params, prompts[0], failures)
    metrics.update(logits)
    return launches, fp32_launches, metrics


def check_per_layer(engine, tokens, failures):
    """Each layer's kernel against its plain version on that layer's own
    inputs in the engine's bf16 model: attention on its q/k/v within TOL
    plus the bound of its bf16 probabilities (``attention_within``), the
    RG-LRU scan on its a/b within SCAN_TOL. The hidden state is carried
    along the plain path, so every layer sees real inputs. Beside it, how
    many elements fall outside TOL alone for the kernel and for the
    reference model's two attention functions on the same inputs."""
    cfg, p = engine.cfg, engine.params
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    worst = {"attn": 0.0, "rglru": 0.0}
    outside = {"kernel": 0, "chunked twin": 0, "naive": 0}
    bad = []
    with torch.inference_mode():
        x = layers.embed_lookup(p["embed"], tokens).to(torch.bfloat16)
        for i, kind in enumerate(cfg.pattern_for_layers()):
            if "scan" in p["blocks"]:
                lp = tree_map_with_path(lambda _, t: t[i], p["blocks"]["scan"])
            else:
                lp = p["blocks"]["layers"][i]
            h = layers.rmsnorm(lp["norm1"], x)
            if kind == "attn":
                q, k, v = attention._project_qkv(lp["attn"], h, positions, cfg.rope_theta)
                kw = dict(causal=True, window=cfg.local_window)
                got = ops.flash_attention(q, k, v, force="kernel", **kw)
                err, n_out = attention_within(got, q, k, v, **kw)
                ok = n_out == 0
                want = ops.flash_attention(q, k, v, force="ref", **kw)
                for name, out in (("kernel", got),
                                  ("chunked twin", attention.chunked_attention(q, k, v, **kw)),
                                  ("naive", attention.naive_attention(q, k, v, **kw))):
                    outside[name] += outside_tol(out, want)
            else:
                u = recurrent.causal_conv(lp["conv"], interior_einsum("bsd,dw->bsw", h, lp["w_x"]))
                log_a, bb = recurrent._rglru_coeffs(lp["lru"], u, cfg.n_heads)
                a = torch.exp(log_a)
                (hk, lk), (hr, lr) = (ops.rglru_scan(a, bb, force=f) for f in ("kernel", "ref"))
                (err, ok), (err_l, ok_l) = (max_err(hk, hr, SCAN_TOL[torch.float32]),
                                            max_err(lk, lr, SCAN_TOL[torch.float32]))
                err = max(err, err_l)
                ok = ok and ok_l and torch.equal(hk, hr) and torch.equal(lk, lr)
            worst[kind] = max(worst[kind], err)
            if not ok:
                bad.append((i, kind))
            x, _, _ = blocks.apply_block(lp, x, cfg, kind, positions=positions, force="ref")
    torch.cuda.synchronize()
    label = f"{cfg.name} B{b} S{s}"
    print(f"{label} per layer, kernel vs plain on each layer's own inputs "
          f"({len(cfg.pattern_for_layers())} layers; attention bf16 tol "
          f"{TOL[torch.bfloat16]} + {P_ROUNDING:g} softmax.|V|, scan fp32 tol "
          f"{SCAN_TOL[torch.float32]} and bit for bit): worst max_abs_err attention "
          f"{worst['attn']:.3e}, "
          f"scan {worst['rglru']:.3e}; layers out of tolerance {bad}")
    if "attn" in cfg.pattern_for_layers():
        print(f"{label} attention elements outside tol {TOL[torch.bfloat16]} alone, against "
              f"the plain version: " + ", ".join(f"{k} {n}" for k, n in outside.items())
              + " (kernel: this bf16 route; chunked twin and naive: the reference model's "
              "two attention functions on the same inputs)")
    if bad:
        failures.append(f"{label}: kernels disagree with the plain versions at layers {bad}")
    out = {f"per_layer_max_abs_err ({label}, {k})": v for k, v in worst.items()
           if k in cfg.pattern_for_layers()}
    if "attn" in cfg.pattern_for_layers():
        out[f"per_layer_outside_tol ({label})"] = outside
    return out


def true_fan_in(params, cfg):
    """The seeded weights with the attention projections rescaled to their
    true fan-in (d_model into q/k/v, heads x head_dim into the output). The
    reference init divides by the size of the heads axis instead
    (repro/nn/params.py ``_fan_in``): for smollm q and k come out with std 8
    and 14, for recurrentgemma's single kv head k gets std 1 where 1/50
    would be its fan-in's; attention is nearly one-hot, and the random
    network is chaotic at depth: two correct paths that round differently
    end in unrelated logits (the default-init line of ``check_logits``)."""
    d, hd = cfg.d_model, cfg.hd
    rescale = {"attn/wq": math.sqrt(cfg.n_heads / d),
               "attn/wk": math.sqrt(cfg.n_kv_heads / d),
               "attn/wv": math.sqrt(cfg.n_kv_heads / d),
               "attn/wo": math.sqrt(hd / (cfg.n_heads * hd)),
               # whisper's cross-attention: every projection has n_heads heads
               **{f"cross/w{n}": math.sqrt(cfg.n_heads / d) for n in "qkv"},
               "cross/wo": math.sqrt(hd / (cfg.n_heads * hd))}

    def scale(path, t):
        key = "/".join(path.split("/")[-2:])
        return t * rescale[key] if key in rescale else t

    return tree_map_with_path(scale, params)


def last_logits(cfg, params, tokens, force, frames=None):
    """The prefill step's last logits; an encoder-decoder's encodes
    ``frames``, cast to the config's dtype."""
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames.to(getattr(torch, cfg.dtype))
    with torch.inference_mode():
        _, _, last = steps.make_prefill_step(cfg, force=force)(params, batch)
    return last


@contextlib.contextmanager
def patched(replacements):
    """Within the block, each ``module.name`` of ``replacements`` ({(module,
    name): fn}) is ``fn``: the model's calls of it go there."""
    orig = {key: getattr(*key) for key in replacements}
    for (mod, name), fn in replacements.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)


def swapped(fns):
    """Within the block, the model's calls of ``ops.<name>`` go to
    ``fns[name]`` instead."""
    return patched({(ops, name): fn for name, fn in fns.items()})


def plain(name):
    """``ops.<name>`` with its plain version forced."""
    fn = getattr(ops, name)
    return lambda *args, force=None, **kw: fn(*args, force="ref", **kw)


def reference_rounding(q, k, v, force=None, **kw):
    """Plain attention with the reference model's bf16 rounding points (q
    scaled and probabilities rounded in the model's dtype)."""
    return attention.naive_attention(q, k, v, **kw)


def chunked_rounding(q, k, v, force=None, **kw):
    """Plain attention with the rounding points of the chunked twin the
    reference model runs (unnormalized probabilities rounded for P.V)."""
    return attention.chunked_attention(q, k, v, **kw)


def routing(record=None, pinned=None, own=None):
    """Within the block, ``moe.router_topk`` appends each MoE layer's
    routing to ``record``: its choices (T, k) and each token's gap between
    its k-th and (k+1)-th router probability (T,). Or it takes the choices,
    call by call, from ``pinned``: the weights are then the path's own
    router probabilities at those experts, renormalized over the k, the aux
    loss counts the pinned top choices, and the choices the path would have
    made itself go to ``own``. With neither, nothing changes. A train step
    under remat calls each layer's router again in its backward (layers in
    reverse order): a record of a step pins the same calls of another."""
    router_topk, pins = moe.router_topk, iter(pinned or ())

    def routed(p_router, x, top_k):
        w, idx, aux = router_topk(p_router, x, top_k)
        if record is not None:
            with torch.no_grad():  # a record with a graph would hold the step's activations
                top = torch.softmax(x.float() @ p_router, dim=-1).topk(top_k + 1, dim=-1).values
            record.append((idx, top[:, top_k - 1] - top[:, top_k]))
            return w, idx, aux
        own.append(idx)
        idx = next(pins)
        probs = torch.softmax(x.float() @ p_router, dim=-1)
        w = probs.gather(-1, idx)
        return (w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), idx,
                moe.load_balance_aux(probs, idx))

    active = record is not None or pinned is not None
    return patched({(moe, "router_topk"): routed} if active else {})


def routing_flips(own, plain, n_experts):
    """Where a path's routing choices ``own`` ([(T, k)] a layer) leave the
    plain path's (``plain``: [(choices, gaps)] a layer): per layer, the
    choices lost (each expert a token's set lost counts once), and the
    plain path's k-th to (k+1)-th probability gaps at the tokens whose set
    changed."""
    counts, gaps = [], []
    for x, (y, gap) in zip(own, plain, strict=True):
        lost = (torch.nn.functional.one_hot(x, n_experts).sum(1)
                - torch.nn.functional.one_hot(y, n_experts).sum(1)).clamp(min=0)
        counts.append(int(lost.sum()))
        gaps += gap[lost.sum(-1) > 0].tolist()
    return counts, gaps


def check_routing(cfg, label, run, own, chosen, gated, failures):
    """Prints how far ``run``'s routing choices ``own`` left the plain
    path's ``chosen``; where ``gated`` (the fp32 run) fails when more than
    ROUTE_FLIP_LIMIT of the choices moved or, for the pinned run, when any
    token that moved had a plain-path gap above ROUTE_GAP_TOL."""
    flipped, gaps = routing_flips(own, chosen, cfg.n_experts)
    t, k = chosen[0][0].shape
    share = sum(flipped) / (t * k * len(flipped))
    worst = max(gaps, default=0.0)
    print(f"{cfg.name} routing ({label}, {run}): choices that differ from the plain "
          f"path's, per layer of {t} x {k}: {flipped} (total {sum(flipped)}, "
          f"{100 * share:.4f}%); the plain path's k-th to (k+1)-th probability gap at "
          f"the {len(gaps)} tokens whose set moved: max {worst:.3e}, sorted "
          f"{[float(f'{g:.3e}') for g in sorted(gaps)[-12:]]}")
    if gated and (share > ROUTE_FLIP_LIMIT
                  or (run == "pinned" and worst > ROUTE_GAP_TOL)):
        failures.append(f"{cfg.name} routing ({label}, {run}): {sum(flipped)} choices "
                        f"({100 * share:.4f}%, limit {100 * ROUTE_FLIP_LIMIT}%) moved, "
                        f"the widest plain gap among them {worst:.3e} (limit "
                        f"{ROUTE_GAP_TOL} in the pinned run)")
    return {f"routing_choices_differ ({cfg.name}, {label}, {run})": flipped,
            f"routing_flipped_gap_max ({cfg.name}, {label}, {run})": worst}


def check_logits(cfg, params, tokens, failures, frames=None):
    """Prefill's last logits through the kernels against the plain
    versions, at full width. Asserted on the true-fan-in weights: in fp32
    within 1e-3, in bf16 within the larger of 0.1 and the spread of correct
    bf16 paths on the same weights and tokens (the plain path against the
    plain path with attention rounded as each of the reference model's two
    attention functions rounds it: ``naive_attention`` and the chunked twin
    the model runs), since a kernel cannot be held closer to one correct
    rounding than another correct rounding is. Reported only: the default
    init, and, where the model runs both kernels, one kernel at a time.

    The fp32 run is the fp32 flash route's main path: its launches are
    counted from 0 just before it and read just after, and must be one
    flash launch per attention layer (one scan launch per rglru layer), all
    on fp32 inputs. Returns (metrics, those launches).

    An MoE arch's router makes discrete choices: where two paths that
    round differently (even in fp32, by the order of sums) put a token's
    router probabilities on either side of a tie, or move which rows
    overflow an expert's capacity, that token's FFN output changes as a
    whole. So each run of an MoE arch is held to the plain path with the
    routing pinned to the plain path's choices (``routing``), and the same
    run with its own routing is reported beside it, with how many choices
    differ. Routing is held too, in the fp32 run (``check_routing``): in
    the pinned run each layer's router sees the plain path's upstream
    choices, so the choices it would have made itself may leave the plain
    path's only at near-ties (gap at most ROUTE_GAP_TOL); in both runs at
    most ROUTE_FLIP_LIMIT of the choices may move.

    An encoder-decoder's prefill step encodes ``frames`` too (cast to each
    run's dtype: fp32 frames in the fp32 run), and its fp32 run launches
    flash once an encoder and once a decoder layer."""
    fan_in = true_fan_in(params, cfg)
    scan_plain = {"rglru_scan": plain("rglru_scan")}
    flash_dtypes, flash_attention = [], ops.flash_attention

    def flash_recording(q, k, v, **kw):  # the kernel path, recording q's dtype
        flash_dtypes.append(q.dtype)
        return flash_attention(q, k, v, **kw)

    spread_runs = {
        "true fan-in, bf16, plain with the reference model's attention rounding":
            {"flash_attention": reference_rounding, **scan_plain},
        "true fan-in, bf16, plain with the reference model's chunked-twin rounding":
            {"flash_attention": chunked_rounding, **scan_plain}}
    spreads = []
    runs = [(label, cfg, fan_in, None, fns) for label, fns in spread_runs.items()]
    runs += [("default init, bf16", cfg, params, None, {}),
            ("true fan-in, bf16", cfg, fan_in, "spread", {}),
            ("true fan-in, fp32", cfg.replace(dtype="float32"),
             tree_map_with_path(lambda _, t: t.float(), fan_in),
             LOGITS_TOL[torch.float32], {"flash_attention": flash_recording})]
    if "rglru" in cfg.pattern_for_layers():
        runs += [("true fan-in, bf16, flash kernel only", cfg, fan_in, None,
                  {"rglru_scan": plain("rglru_scan")}),
                 ("true fan-in, bf16, scan kernel only", cfg, fan_in, None,
                  {"flash_attention": plain("flash_attention")})]
    out, fp32_launches = {}, {}
    for label, run_cfg, run_params, tol, fns in runs:
        fp32 = run_cfg.dtype == "float32"
        chosen, held = [], []  # the plain path's routing, pinned in the run
        if cfg.is_moe:
            with routing(record=chosen):
                want = last_logits(run_cfg, run_params, tokens, "ref")
        if fp32:
            ops.reset_launch_counts()
        with swapped(fns), routing(pinned=[c for c, _ in chosen] if cfg.is_moe else None,
                                   own=held):
            last = last_logits(run_cfg, run_params, tokens, None, frames)
        if fp32:
            fp32_launches = ops.launch_counts()
            kinds = cfg.pattern_for_layers()
            expect_launches(f"{cfg.name} fp32 prefill (the fp32 flash route's main path)",
                            fp32_launches, {"flash_attention": kinds.count("attn")
                                            + cfg.n_enc_layers,
                                            "rglru_scan": kinds.count("rglru"),
                                            "rglru_scan_bwd": 0}, failures)
            if set(flash_dtypes) != {torch.float32}:
                failures.append(f"{cfg.name} fp32 prefill: flash inputs of dtypes "
                                f"{sorted(map(str, set(flash_dtypes)))}, want float32 only")
        if cfg.is_moe:
            own = []
            with swapped(fns), routing(record=own):
                free = last_logits(run_cfg, run_params, tokens, None)
            free_err = (free - want).abs().max().item()
            print(f"{cfg.name} prefill last logits against the plain path ({label}), the run "
                  f"with its own routing (reported): max_abs_err={free_err:.3e}")
            out[f"logits_max_abs_err ({cfg.name}, {label}, own routing)"] = free_err
            gated = fp32 and tol is not None
            out.update(check_routing(cfg, label, "pinned", held, chosen, gated, failures))
            out.update(check_routing(cfg, label, "own routing", [c for c, _ in own], chosen,
                                     gated, failures))
            del free
        else:
            want = last_logits(run_cfg, run_params, tokens, "ref", frames)
        torch.cuda.synchronize()
        err = (last - want).abs().max().item()
        if label in spread_runs:
            spreads.append(err)
        if tol == "spread":
            tol = max(LOGITS_TOL[torch.bfloat16], *spreads)
        same = last.argmax(-1) == want.argmax(-1)
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        print(f"{cfg.name} prefill last logits against the plain path ({label}"
              f"{', routing pinned to the plain path' if cfg.is_moe else ''}): "
              f"max_abs_err={err:.3e} tol={tol} argmax equal on {int(same.sum())}/"
              f"{len(want)} rows (plain top-1 margins "
              f"{[round(m, 4) for m in margin.tolist()]}) "
              f"finite={bool(torch.isfinite(last).all())}")
        out[f"logits_max_abs_err ({cfg.name}, {label})"] = err
        if tol is None:
            continue
        # Where the plain top-1 margin exceeds 2 tol, logits within tol
        # cannot change the argmax; closer races are reported above.
        decided = margin > 2 * tol
        if not (err <= tol and bool(same[decided].all())
                and bool(torch.isfinite(last).all())
                and tuple(last.shape) == (tokens.shape[0], cfg.vocab_size)):
            failures.append(f"{cfg.name} prefill logits ({label}): err {err:.3e} "
                            f"(tol {tol}), argmax differs on "
                            f"{int((~same & decided).sum())} decided rows")
    return out, fp32_launches


# --------------------------------------------------------------------------
# the decoder-only attention archs: QKV bias, QK-norm, the MoE FFN
# --------------------------------------------------------------------------

def spans(targets):
    """Within the block, each ``module.name`` of ``targets`` ({label:
    (module, name)}) runs inside ``record_function(label)``."""
    def wrap(label, fn):
        def spanned(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return spanned

    return patched({(mod, name): wrap(label, getattr(mod, name))
                    for label, (mod, name) in targets.items()})


# xlstm's two sequence mixers, the parts of its prefills and train steps
XLSTM_SPANS = {"slstm loop": (blocks, "slstm_scan"),
               "mlstm chunkwise": (blocks, "mlstm_chunkwise")}
# The parts of a prefill, each the device time of the kernels launched inside
# the function that computes it (nested: the router, the dispatch and the
# experts lie inside the MoE FFN)
PREFILL_SPANS = {"flash": (ops, "flash_attention"), "unembed": (lm, "unembed"),
                 "moe": (moe, "moe_ffn_local"), "moe router": (moe, "router_topk"),
                 "moe dispatch": (moe, "_dispatch_indices"),
                 "moe experts": (moe, "_expert_ffn"), **XLSTM_SPANS}
# the parts that hold no other (the rest is what none of them holds)
OUTER_PARTS = ("flash", "unembed", "moe", *XLSTM_SPANS)


def merged(by_thread):
    """{thread: [(start_ns, end_ns), ...]} with each thread's windows sorted
    and those that overlap joined."""
    out = {}
    for tid, windows in by_thread.items():
        run = []
        for lo, hi in sorted(windows):
            if run and lo <= run[-1][1]:
                run[-1] = (run[-1][0], max(run[-1][1], hi))
            else:
                run.append((lo, hi))
        out[tid] = run
    return out


def within(windows, tid, t):
    """Whether time ``t`` on host thread ``tid`` lies in ``windows`` (``merged``)."""
    run = windows.get(tid, ())
    i = bisect.bisect_right(run, (t, math.inf)) - 1
    return i >= 0 and t <= run[i][1]


def host_ms(windows, lo, hi):
    """The host ms of ``windows`` (``merged``) inside [lo, hi], summed over threads."""
    return sum(max(0, min(b, hi) - max(a, lo)) for run in windows.values() for a, b in run) / 1e6


def span_windows(cpu, labels):
    """{label: ``merged`` windows} from a trace's host records ``cpu``: each
    span of ``labels`` (as ``spans`` opens them), and the backward calls
    (``autograd::engine::evaluate_function``) of the autograd nodes that ops
    inside a span made, matched by forward thread and sequence number as
    the profiler's own event tree matches them (on the card, autograd runs
    the backward on a thread of its own)."""
    raw = {label: {} for label in labels}
    for e in cpu:
        if e.name() in raw:
            raw[e.name()].setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns()))
    spans_only = {label: merged(by_thread) for label, by_thread in raw.items()}
    nodes = {label: set() for label in labels}
    for e in cpu:
        if e.sequence_nr() >= 0 and not e.name().startswith("autograd::"):
            for label in labels:
                if within(spans_only[label], e.start_thread_id(), e.start_ns()):
                    nodes[label].add((e.start_thread_id(), e.sequence_nr()))
    for e in cpu:
        if e.name().startswith("autograd::engine::evaluate_function"):
            for label in labels:
                if (e.fwd_thread_id(), e.sequence_nr()) in nodes[label]:
                    raw[label].setdefault(e.start_thread_id(), []).append(
                        (e.start_ns(), e.end_ns()))
    return {label: merged(by_thread) for label, by_thread in raw.items()}


def launches_of(cpu):
    """{correlation id: (host thread, start_ns)} of a trace's CUDA API calls."""
    return {e.correlation_id(): (e.start_thread_id(), e.start_ns())
            for e in cpu if e.name().startswith("cu")}


def profile_generate(engine, prompts, gen):
    """One ``generate`` under torch.profiler: each phase's wall time, device
    busy time and share, the prefill's (an encoder-decoder's: the encode's)
    device time by part (PREFILL_SPANS, the other GEMMs by kernel name, the
    rest) and its host time by span (PREFILL_SPANS, on the host's clock
    under the profiler). A device
    record belongs to a part when the host call that launched it (matched by
    correlation id) lies inside the part's span. Kineto drops the first GPU
    records of a session, so the session opens with one CUDA operation of
    its own."""
    engine.generate(prompts, gen)  # warm
    torch.cuda.synchronize()
    with spans(PREFILL_SPANS), profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").sum().item()
        engine.generate(prompts, gen)
    events = prof.profiler.kineto_results.events()
    labels = set(PREFILL_SPANS) | set(PHASES)  # PHASES: generate's own spans
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    launch_at = launches_of(cpu)
    phase_at = {}
    for e in cpu:
        if e.name() in PHASES:
            phase_at.setdefault(e.name(), (e.start_ns(), e.end_ns()))
    windows = span_windows(cpu, PREFILL_SPANS)
    device = [e for e in events if e.device_type() == DeviceType.CUDA and e.name() not in labels]

    def inside(label, e):
        at = launch_at.get(e.correlation_id())
        return at is not None and within(windows[label], *at)

    main = "encode" if "encode" in phase_at else "prefill"
    out = {}
    for phase in PHASES:
        if phase not in phase_at:
            continue
        lo, hi = phase_at[phase]
        ran = [e for e in device if lo <= e.start_ns() and e.end_ns() <= hi]
        busy = sum(e.end_ns() - e.start_ns() for e in ran) / 1e6
        wall = (hi - lo) / 1e6
        out[phase] = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
                      "device_records": len(ran)}
        if phase == main:
            ms = lambda keep: sum(e.end_ns() - e.start_ns() for e in ran if keep(e)) / 1e6  # noqa: E731
            parts = {label: ms(lambda e, label=label: inside(label, e)) for label in PREFILL_SPANS}
            parts["other GEMMs (projections, MLP)"] = ms(
                lambda e: GEMM_KERNEL.search(e.name()) is not None
                and not any(inside(label, e) for label in OUTER_PARTS[1:]))
            parts["moe combine and gathers"] = parts["moe"] - sum(
                parts[k] for k in ("moe router", "moe dispatch", "moe experts"))
            parts["rest"] = busy - sum(parts[k] for k in (*OUTER_PARTS,
                                                          "other GEMMs (projections, MLP)"))
            out[f"{main}_parts_ms"] = parts
            host = {label: host_ms(windows[label], lo, hi) for label in PREFILL_SPANS}
            host["rest"] = wall - sum(host[k] for k in OUTER_PARTS)
            out[f"{main}_host_ms"] = {k: v for k, v in host.items() if v}
    b, s = prompts.shape
    pf, dec = out[main], out["decode"]
    print(f"{engine.cfg.name} profiled generate B{b} S{s} gen {gen}: {main} wall "
          f"{pf['wall_ms']:.2f} ms, busy {pf['busy_ms']:.2f} ms ({100 * pf['busy_share']:.1f}%); "
          f"decode ({gen - 1} steps) wall {dec['wall_ms']:.2f} ms, busy {dec['busy_ms']:.2f} ms "
          f"({100 * dec['busy_share']:.1f}%); the {main}'s device time by part: "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / pf['busy_ms']:.1f}%)"
                      for k, v in out[f"{main}_parts_ms"].items()
                      if v or not k.startswith(("moe", "slstm", "mlstm")))
          + "; its host time by span: "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / pf['wall_ms']:.1f}%)"
                      for k, v in out[f"{main}_host_ms"].items()))
    return out


def check_bias_rounding(engine, tokens, failures):
    """The QKV bias joins the fp32-accumulated product before its one
    rounding to bf16 (``attention._project``, cuBLAS's addmm), as the
    reference adds it to the fp32 product: on layer 0's wq and real inputs,
    with a seeded nonzero bias (the init's are zeros), the port's projection
    must equal the fp32 product plus the bias rounded once on at least 99%
    of the elements (sums in another order flip a rounding where a value
    lies within the fp32 sums' error of a bf16 boundary: about 0.1% at
    d_model 2048), and on at least 10 points more of them than the product
    rounded first and then the sum does."""
    cfg, p = engine.cfg, engine.params
    lp = (tree_map_with_path(lambda _, t: t[0], p["blocks"]["scan"]) if "scan" in p["blocks"]
          else p["blocks"]["layers"][0])
    gen = torch.Generator(device="cuda").manual_seed(6)
    bias = torch.randn((cfg.n_heads, cfg.hd), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        x = layers.rmsnorm(lp["norm1"], layers.embed_lookup(p["embed"], tokens).to(torch.bfloat16))
        got = attention._project(x, lp["attn"]["wq"], bias)
        prod = torch.einsum("bsd,dhk->bhsk", x.float(), lp["attn"]["wq"].float())  # TF32 off
        b32 = bias.float()[None, :, None]
        once = (prod + b32).to(torch.bfloat16)
        twice = (prod.to(torch.bfloat16).float() + b32).to(torch.bfloat16)
    same_once = (got == once).float().mean().item()
    same_twice = (got == twice).float().mean().item()
    ok = same_once >= 0.99 and same_once - same_twice >= 0.1
    print(f"{cfg.name} QKV bias rounding (layer 0 wq, B{tokens.shape[0]} S{tokens.shape[1]}, "
          f"seeded bias): the port's projection equals the fp32 product + bias rounded once on "
          f"{100 * same_once:.3f}% of elements, rounded twice (product, then sum) on "
          f"{100 * same_twice:.3f}% {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{cfg.name}: the QKV bias is not added before the one rounding "
                        f"({100 * same_once:.3f}% equal)")
    return {"bias_rounding_equal_once": same_once, "bias_rounding_equal_twice": same_twice}


def check_repeat(engine, tokens, failures):
    """Two prefills of the same prompts through the kernels must give
    bit-equal last logits and KV caches (an MoE arch's dispatch and combine
    use no atomics)."""
    prefill = steps.make_prefill_step(engine.cfg)
    with torch.inference_mode():
        (_, sa, la), (_, sb, lb) = (prefill(engine.params, {"tokens": tokens}) for _ in range(2))
    torch.cuda.synchronize()
    same = torch.equal(la, lb) and torch.equal(sa.k, sb.k) and torch.equal(sa.v, sb.v)
    print(f"{engine.cfg.name} two prefills of the same prompts: last logits and KV caches "
          f"{'equal bit for bit' if same else 'DIFFER'}")
    if not same:
        failures.append(f"{engine.cfg.name}: two prefills of the same prompts differ")
    return {"two_prefills_bit_equal": same}


def phase_decoder(arch, failures):
    """One decoder-only attention arch's serving path at full width: the 3
    ``infer`` requests and ``generate`` 8 x 512 -> 32, counted (one flash
    launch a layer a prefill); per-layer attention against the plain
    version; a profiled generate; the QKV bias's rounding point where the
    arch has the bias; an MoE arch's routing against the plain path's and
    two prefills bit-equal; then, with the engine gone and the caches freed,
    the last logits in bf16 and fp32 (the fp32 run counted) and the peak
    memory of those checks. Returns (launches, fp32 launches, metrics)."""
    t_phase = time.perf_counter()
    generates = [(8, 512, 32)]
    engine, launches, prompts, metrics = serve(arch, generates, failures)
    cfg = engine.cfg
    n_prefills = len(INFER_PAYLOADS) + len(generates)
    expect_launches(arch, launches, {"flash_attention": cfg.n_layers * n_prefills,
                                     "rglru_scan": 0, "rglru_scan_bwd": 0}, failures)
    metrics.update(check_per_layer(engine, prompts[0], failures))
    metrics["profile"] = profile_generate(engine, prompts[0], 8)
    if cfg.qkv_bias:
        metrics.update(check_bias_rounding(engine, prompts[0], failures))
    if cfg.is_moe:
        metrics.update(check_repeat(engine, prompts[0], failures))
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logits, fp32_launches = check_logits(cfg, params, prompts[0], failures)
    metrics.update(logits)
    metrics["logits_checks_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch} logits checks: peak device memory {metrics['logits_checks_peak_gib']:.2f} GiB "
          f"(the bf16 weights, their true-fan-in copy, an fp32 copy); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, fp32_launches, metrics


def greedy(cfg, params, tokens, force, n_steps):
    """Prefill through ``force``'s path, then ``n_steps`` greedy decode
    steps: (prefill's last logits, [each step's logits], tokens (B, 1 +
    n_steps))."""
    b, s = tokens.shape
    with torch.inference_mode():
        tok, pf_states, last = steps.make_prefill_step(cfg, force=force)(params, {"tokens": tokens})
        states = _install_prefill(steps.decode_state(cfg, b, s + n_steps, tokens.device),
                                  pf_states)
        toks, step_logits = [tok], []
        for i in range(n_steps):
            logits, states = lm.lm_apply(params, tok, cfg, mode="decode", states=states,
                                         cache_len=s + i)
            step_logits.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1:], dim=-1)
            toks.append(tok)
    return last, step_logits, torch.cat(toks, dim=1)


def phase_tiny_archs(failures):
    """chameleon-34b (QK-norm), deepseek-coder-33b and qwen3-moe-235b-a22b
    (QK-norm, MoE) at their tiny configs on the card: 4 prompts of 64
    tokens, a prefill and TINY_DECODE_STEPS greedy decode steps through the
    kernels against the plain path, in fp32 (last logits within 1e-3, the
    tokens equal wherever the plain path's top-1 margin decides them) and in
    bf16 (last logits within 0.1); each prefill launches flash once a layer,
    counted from 0 just before it. Returns {"<arch> <dtype>": launches}."""
    out = {}
    for arch in TINY_ARCHS:
        base = get_tiny_config(arch)
        gen = torch.Generator(device="cpu").manual_seed(0)
        tokens = torch.randint(0, base.vocab_size, (4, 64), generator=gen).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            cfg = base.replace(dtype=str(dtype).split(".")[-1])
            params = steps.init_params(cfg, 0, "cuda")
            ops.reset_launch_counts()
            last, step_logits, toks = greedy(cfg, params, tokens, None, TINY_DECODE_STEPS)
            launches = ops.launch_counts()
            want_last, want_steps, want_toks = greedy(cfg, params, tokens, "ref",
                                                      TINY_DECODE_STEPS)
            torch.cuda.synchronize()
            tol = LOGITS_TOL[dtype]
            err = (last - want_last).abs().max().item()
            # the first step where the paths' tokens part, and whether the plain
            # path's top-1 margin there left it undecided within tol
            parted = [i for i in range(toks.shape[1]) if not torch.equal(toks[:, i], want_toks[:, i])]
            margins = [float((lg.topk(2, dim=-1).values[:, 0] - lg.topk(2, dim=-1).values[:, 1]).min())
                       for lg in [want_last] + want_steps]
            decided = not parted or margins[parted[0]] > 2 * tol
            ok = (err <= tol and bool(torch.isfinite(last).all())
                  and (dtype == torch.bfloat16 or not (parted and decided)))
            print(f"{arch} tiny {cfg.dtype} on the card ({cfg.n_layers} layers, B4 S64 + "
                  f"{TINY_DECODE_STEPS} decode steps): prefill last logits against the plain path "
                  f"max_abs_err={err:.3e} tol={tol}; tokens {'equal' if not parted else f'part at step {parted[0]} (plain top-1 margin there {margins[parted[0]]:.2e})'}"
                  f"; launches {launches} {'ok' if ok else 'FAIL'}")
            expect_launches(f"{arch} tiny {cfg.dtype} prefill", launches,
                            {"flash_attention": cfg.n_layers, "rglru_scan": 0,
                             "rglru_scan_bwd": 0}, failures)
            if not ok:
                failures.append(f"{arch} tiny {cfg.dtype}: logits err {err:.3e}, tokens part at "
                                f"{parted[:1]}")
            out[f"{arch} tiny {cfg.dtype}"] = launches
            del params
    return out


def handoff_logits(cfg, params, tokens):
    """Prefill ``tokens[:, :-1]``, install its states in a decode state,
    then one decode step of ``tokens[:, -1:]``: (the prefill's last logits,
    the decode step's)."""
    b, s = tokens.shape[0], tokens.shape[1] - 1
    with torch.inference_mode():
        _, pf_states, last = steps.make_prefill_step(cfg)(params, {"tokens": tokens[:, :s]})
        states = _install_prefill(steps.decode_state(cfg, b, s + 1, tokens.device), pf_states)
        logits, _ = lm.lm_apply(params, tokens[:, s:], cfg, mode="decode", states=states,
                                cache_len=s)
    return last, logits[:, -1]


def mlstm_stepwise(q, k, v, i_gate, f_gate, state=None, chunk=None):
    """``mlstm_chunkwise``'s signature over the stepwise oracle: patched in
    for it (``patched(STEPWISE)``), every mLSTM block runs the oracle."""
    return recurrent.mlstm_ref(q, k, v, i_gate, f_gate, state)


STEPWISE = {(blocks, "mlstm_chunkwise"): mlstm_stepwise}


def check_within(label, got, want, tol, failures):
    err = (got - want).abs().max().item()
    ok = err <= tol and bool(torch.isfinite(got).all())
    print(f"{label}: max_abs_err {err:.3e} (max |logit| {want.abs().max().item():.3f}) tol {tol} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: max_abs_err {err:.3e} > {tol}")
    return err


def check_xlstm_forms(cfg, params, prompts, failures):
    """fp32 through the model (``cfg`` fp32, ``params`` the seeded weights in
    fp32), each within XLSTM_TOL: the last logits through the chunkwise
    mLSTM against the stepwise oracle, at 1 x 2048 (four chunks of 512) and
    8 x 512 (one); the decode hand-off (a prefill of S tokens, then one
    decode step, against the same S + 1 tokens in one pass) at S = 511 (the
    pass a prefill of 512) and at S = 2048 (the pass the stepwise oracle
    over 2049 tokens, a length no chunk of 512 divides). The model is
    causal, so the stepwise pass over 2049 tokens gives the oracle's last
    logits of the first 2048 too."""
    out = {}
    gen = torch.Generator(device="cpu").manual_seed(8)
    extra = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen).cuda()
    long, short = torch.cat([prompts[1], extra], dim=1), prompts[0]
    t0 = time.perf_counter()
    with torch.inference_mode(), patched(STEPWISE):
        oracle_long = lm.lm_apply(params, long, cfg, mode="prefill")[0][:, -2:]
        oracle_short = lm.lm_apply(params, short, cfg, mode="prefill")[0][:, -1]
    t1 = time.perf_counter()
    chunk_long, handoff_long = handoff_logits(cfg, params, long)
    chunk_short = last_logits(cfg, params, short, None)
    _, handoff_short = handoff_logits(cfg, params, short)
    torch.cuda.synchronize()
    print(f"{cfg.name} fp32 forms: stepwise passes ({long.shape[1]} and {short.shape[0]} x "
          f"{short.shape[1]} tokens) "
          f"{t1 - t0:.1f} s, chunkwise prefills and hand-offs {time.perf_counter() - t1:.1f} s "
          "(host clock)")
    (bl, sl), (bs, ss) = prompts[1].shape, short.shape
    nc = -(-sl // cfg.attn_chunk)
    for key, label, got, want in (
            (f"chunkwise_vs_stepwise B{bl} S{sl}", f"B{bl} S{sl} last logits, mLSTM chunkwise "
             f"({nc} chunks) against stepwise", chunk_long, oracle_long[:, 0]),
            (f"chunkwise_vs_stepwise B{bs} S{ss}", f"B{bs} S{ss} last logits, mLSTM chunkwise "
             "against stepwise", chunk_short, oracle_short),
            (f"handoff S{ss - 1}", f"B{bs} decode hand-off at S={ss - 1} (prefill {ss - 1} + 1 "
             f"decode step against a prefill of {ss})", handoff_short, chunk_short),
            (f"handoff S{sl}", f"B{bl} decode hand-off at S={sl} (prefill {sl} + 1 decode step "
             f"against the stepwise oracle over {sl + 1})", handoff_long, oracle_long[:, 1])):
        out[key] = check_within(f"{cfg.name} fp32 {label}", got, want, XLSTM_TOL, failures)
    return out


def phase_xlstm(failures):
    """xlstm-125m's serving path at full width (12 layers alternating mlstm /
    slstm, list layout, seeded random weights): the 3 ``infer`` requests,
    ``generate`` 8 x 512 -> 32 and 1 x 2048 -> 8, counted (no kernel of the
    port on this path: every count 0); a profiled generate; then, in fp32
    on the same weights, ``check_xlstm_forms``. Returns (launches, metrics)."""
    t_phase = time.perf_counter()
    engine, launches, prompts, metrics = serve(XLSTM, XLSTM_GENERATES, failures)
    expect_launches(XLSTM, launches, {"flash_attention": 0, "rglru_scan": 0,
                                      "rglru_scan_bwd": 0}, failures)
    metrics["profile"] = profile_generate(engine, prompts[0], 8)
    cfg = engine.cfg.replace(dtype="float32")
    params = tree_map_with_path(lambda _, t: t.float(), engine.params)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics.update(check_xlstm_forms(cfg, params, prompts, failures))
    metrics["fp32_checks_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{XLSTM} fp32 checks: peak device memory {metrics['fp32_checks_peak_gib']:.2f} GiB; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches, metrics


def phase_cpu_step(arch, failures):
    """One fp32 train step of ``arch`` at full width (B x S of
    CPU_STEP[arch]; xlstm-125m under remat full, whisper-tiny with its full
    1500 frames, fp32) on the card, under deterministic algorithms (set by
    the train phases; ``torch.cumsum`` of a float CUDA tensor would raise
    under them), and the same step of the port on the CPU, from the same
    seeded weights and batch: loss and grad norm within CPU_STEP[arch]'s
    tolerances, relative. Catches what only the card's ops would do."""
    cfg = get_config(arch).replace(dtype="float32")
    (b, s), tols = CPU_STEP[arch]
    batch = train_batches(cfg, s, b, 1)[0]
    if cfg.is_encoder_decoder:
        batch["frames"] = batch["frames"].float()
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    deterministic(torch.device("cuda"))
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state = fresh_states(cfg, torch.device(device))[1]()
        ops.reset_launch_counts()
        state, met = steps.make_train_step(cfg, opt_cfg)(state, batch)
        got[device] = floats(met)
        if device == "cuda":
            launches = ops.launch_counts()
        del state
        print(f"{arch} fp32 train step B{b} S{s} on {device}: loss {got[device]['loss']:.7f}, "
              f"grad norm {got[device]['grad_norm']:.7f} ({time.perf_counter() - t0:.1f} s with "
              f"the weights)")
    expect_launches(f"{arch} fp32 train step on the card", launches, step_launches(cfg, 1),
                    failures)
    out = {"deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
           "launches": launches}
    for key, tol in tols.items():
        rel = abs(got["cuda"][key] - got["cpu"][key]) / abs(got["cpu"][key])
        ok = rel <= tol and math.isfinite(got["cuda"][key])
        print(f"{arch} fp32 step {key}: card against CPU relative difference {rel:.2e} tol {tol} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{arch} fp32 step {key}: card {got['cuda'][key]} vs CPU "
                            f"{got['cpu'][key]}")
        out[key] = {"cuda": got["cuda"][key], "cpu": got["cpu"][key], "rel": rel}
    return out


def whisper_frames(cfg, b, seed):
    """(b, enc_seq, d_model) bf16 frames on the card from a seeded generator:
    the reference's stub frontend (no audio)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen).to("cuda", torch.bfloat16)


def check_whisper_per_layer(cfg, params, tokens, frames, failures):
    """Each layer's flash attention through the kernel against its plain
    version on that layer's own inputs, in the engine's bf16 model: the
    prefill step runs on the plain path, and each of its flash calls (the
    encoder's bidirectional, the decoder's causal) is also sent to the
    kernel, within TOL plus the bound of its bf16 probabilities
    (``attention_within``)."""
    flash, seen = ops.flash_attention, []

    def held(q, k, v, force=None, **kw):
        got = flash(q, k, v, force="kernel", **kw)
        err, n_out = attention_within(got, q, k, v, **kw)
        seen.append(("decoder" if kw["causal"] else "encoder", tuple(q.shape), err, n_out))
        return flash(q, k, v, force="ref", **kw)

    with torch.inference_mode(), swapped({"flash_attention": held}):
        steps.make_prefill_step(cfg, force="ref")(params, {"tokens": tokens, "frames": frames})
    torch.cuda.synchronize()
    out = {}
    for part, n in (("encoder", cfg.n_enc_layers), ("decoder", cfg.n_layers)):
        rows = [r for r in seen if r[0] == part]
        worst = max(r[2] for r in rows)
        bad = [i for i, r in enumerate(rows) if r[3]]
        print(f"{cfg.name} per layer, {part} attention {rows[0][1]} "
              f"{'bidirectional' if part == 'encoder' else 'causal'}, kernel vs plain on each "
              f"layer's own inputs ({len(rows)} layers; bf16 tol {TOL[torch.bfloat16]} + "
              f"{P_ROUNDING:g} softmax.|V|): worst max_abs_err {worst:.3e}; layers out of "
              f"tolerance {bad}")
        if len(rows) != n or bad:
            failures.append(f"{cfg.name} {part}: {len(rows)} flash calls (want {n}), "
                            f"layers out of tolerance {bad}")
        out[f"per_layer_max_abs_err ({cfg.name}, {part})"] = worst
    return out


def check_whisper_handoff(cfg, params, tokens, frames, failures):
    """In fp32 (true-fan-in weights, fp32 frames, the memory through the
    fp32 flash route): S greedy-free decode steps of ``tokens[:, :S]``
    (``decode_step`` from position 0) against the teacher-forced decoder
    over the same S tokens on the plain path, at each S of WHISPER_HANDOFF:
    the last logits within LOGITS_TOL's fp32 1e-3, and each position's
    argmax equal wherever the plain top-1 margin exceeds twice that."""
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map_with_path(lambda _, t: t.float(), true_fan_in(params, cfg))
    tol, out = LOGITS_TOL[torch.float32], {}
    b = tokens.shape[0]
    with torch.inference_mode():
        memory = encdec.encode(p32, frames.float(), cfg32)
        for s in WHISPER_HANDOFF:
            toks = tokens[:, :s]
            want = encdec.decode_train(p32, toks, memory, cfg32, force="ref")
            states = encdec.init_decode_state(p32, memory, cfg32, b, s, dtype=torch.float32)
            got = []
            for i in range(s):
                logits, states = encdec.decode_step(p32, toks[:, i:i + 1], states, i, cfg32)
                got.append(logits[:, -1])
            got = torch.stack(got, dim=1)
            top2 = want.topk(2, dim=-1).values
            decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
            same = got.argmax(-1) == want.argmax(-1)
            label = (f"{cfg.name} fp32 decode hand-off at S={s} (B{b}: {s} decode steps against "
                     f"the teacher-forced decoder over {s} tokens), last logits")
            out[f"handoff S{s}"] = check_within(label, got[:, -1], want[:, -1], tol, failures)
            print(f"{cfg.name} fp32 decode hand-off at S={s}: argmax equal at "
                  f"{int(same.sum())}/{same.numel()} positions, {int(decided.sum())} decided by "
                  f"the plain margin, {int((~same & decided).sum())} of those differ")
            if not bool(same[decided].all()):
                failures.append(f"{cfg.name} fp32 hand-off S={s}: decided tokens differ")
    return out


def phase_whisper(failures):
    """whisper-tiny's serving path at full width (4 encoder and 4 decoder
    layers, d_model 384, 6 heads of 64, 1500 frames, seeded random weights):
    the 3 ``infer`` requests and ``generate`` 8 x 1500 frames -> 32 tokens,
    counted (each request encodes once: one flash launch an encoder layer;
    decode launches none); the encode's time; a profiled generate (busy
    shares, the encode's device time by part); the prefill step on 8 x 448
    tokens (encode plus the teacher-forced decoder), counted (a flash launch
    a layer); per-layer attention (``check_whisper_per_layer``); its last
    logits against the plain path (``check_logits``: bf16 within 0.1 or the
    spread, fp32 within 1e-3 with its fp32 flash launches counted); the fp32
    decode hand-off (``check_whisper_handoff``). Returns (serving launches,
    prefill-step launches, fp32 launches, metrics)."""
    t_phase = time.perf_counter()
    engine, launches, prompts, metrics = serve(WHISPER, WHISPER_GENERATES, failures)
    cfg, params = engine.cfg, engine.params
    n_requests = len(INFER_PAYLOADS) + len(WHISPER_GENERATES)
    expect_launches(WHISPER, launches, {"flash_attention": cfg.n_enc_layers * n_requests,
                                        "flash_attention_bwd": 0, "rglru_scan": 0,
                                        "rglru_scan_bwd": 0}, failures)
    frames = whisper_frames(cfg, TRAIN_BATCH, 1)
    with torch.inference_mode():
        encdec.encode(params, frames, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            encdec.encode(params, frames, cfg)
        torch.cuda.synchronize()
    metrics["encode_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"{WHISPER} encode B{TRAIN_BATCH} x {cfg.enc_seq} frames: {metrics['encode_ms']:.2f} ms "
          "(host clock, mean of 5 after one warm-up)")
    metrics["profile"] = profile_generate(engine, prompts[0], 8)

    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, WHISPER_SEQ), generator=gen).cuda()
    prefill = steps.make_prefill_step(cfg)
    batch = {"tokens": tokens, "frames": frames}
    with torch.inference_mode():
        prefill(params, batch)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        nxt, memory, last = prefill(params, batch)
        torch.cuda.synchronize()
    metrics["prefill_step_ms"] = (time.perf_counter() - t0) * 1e3
    pf_launches = ops.launch_counts()
    expect_launches(f"{WHISPER} prefill step B{TRAIN_BATCH} S{WHISPER_SEQ}", pf_launches,
                    {"flash_attention": cfg.n_enc_layers + cfg.n_layers,
                     "flash_attention_bwd": 0, "rglru_scan": 0, "rglru_scan_bwd": 0}, failures)
    ok = (tuple(nxt.shape) == (TRAIN_BATCH, 1) and memory.dtype == torch.bfloat16
          and tuple(memory.shape) == (TRAIN_BATCH, cfg.enc_seq, cfg.d_model)
          and bool(torch.isfinite(memory.float()).all()) and bool(torch.isfinite(last).all()))
    print(f"{WHISPER} prefill step B{TRAIN_BATCH} S{WHISPER_SEQ}: {metrics['prefill_step_ms']:.2f} "
          f"ms (host clock), memory {tuple(memory.shape)} {memory.dtype}, last logits "
          f"{tuple(last.shape)} finite {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{WHISPER} prefill step: bad outputs")
    del nxt, memory, last
    metrics.update(check_whisper_per_layer(cfg, params, tokens, frames, failures))
    logits, fp32_launches = check_logits(cfg, params, tokens, failures, frames)
    metrics.update(logits)
    metrics.update(check_whisper_handoff(cfg, params, tokens, frames, failures))
    print(f"{WHISPER} serving phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, pf_launches, fp32_launches, metrics


# --------------------------------------------------------------------------
# training at full width, and crash-resume through the learner
# --------------------------------------------------------------------------

def profile_step(step_fn, state, batch):
    """One train step under torch.profiler: (new state, wall ms, device busy
    ms, {kernel name: (device ms, launches)}, {part: {"host_ms",
    "device_ms"}}). Busy is the kernels' time inside the step's span (one
    stream, so they do not overlap). The parts are XLSTM_SPANS's, each its
    ``span_windows`` (forward, recompute and backward) on the host's clock
    and the device time of the kernels launched inside them. Read from
    the profiler's raw records (``kineto_results``), not ``events()``, whose
    event tree is slow to build at xlstm's 300,000 kernels a step; the
    session opens with one CUDA operation of its own, since Kineto
    drops a session's first GPU records (ROADMAP C.12)."""
    with spans(XLSTM_SPANS), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").sum().item()
        with record_function("train_step"):
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    span = [e for e in cpu if e.name() == "train_step"][0]
    lo, hi = span.start_ns(), span.end_ns()
    windows = span_windows(cpu, XLSTM_SPANS)
    launch_at = launches_of(cpu)
    labels = {"train_step", *XLSTM_SPANS}
    by_name = {}
    parts = {label: {"host_ms": host_ms(windows[label], lo, hi), "device_ms": 0.0}
             for label in XLSTM_SPANS}
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.name() not in labels \
                and lo <= e.start_ns() and e.end_ns() <= hi:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + (e.end_ns() - e.start_ns()) / 1e6, n + 1)
            at = launch_at.get(e.correlation_id())
            for label in XLSTM_SPANS:
                if at is not None and within(windows[label], *at):
                    parts[label]["device_ms"] += (e.end_ns() - e.start_ns()) / 1e6
    return state, (hi - lo) / 1e6, sum(ms for ms, _ in by_name.values()), by_name, parts


def fresh_states(cfg, device):
    """(params, fresh): the seeded weights (seed 0, the attention
    projections at their true fan-in, and where the arch has QKV biases,
    zeros at init, those drawn N(0, 1) from a seeded generator so that the
    bias path carries values) in ``cfg.dtype`` on the host, and a function
    that returns, at each call, a new train state of them on ``device`` at
    step 0. The weights wait in host memory: a full-width train state fills
    most of the card, and the step updates it in place."""
    params0 = true_fan_in(steps.init_params(cfg, 0, "cpu"), cfg)
    if cfg.qkv_bias:
        gen = torch.Generator(device="cpu").manual_seed(6)
        params0 = tree_map_with_path(
            lambda path, t: (torch.randn(t.shape, generator=gen).to(t.dtype)
                             if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv") else t), params0)

    def fresh():
        params = tree_map_with_path(lambda _, t: t.to(device, copy=True), params0)
        return steps.TrainState(torch.zeros((), dtype=torch.int32, device=device), params,
                                adamw.init(params))

    return params0, fresh


def train_batches(cfg, seq, b, n):
    """n batches of b x seq tokens of the synthetic stream; an
    encoder-decoder's with bf16 frames (b, enc_seq, d_model) drawn from a
    seeded generator (the reference's stub frontend: no audio)."""
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, b, seed=0))
    gen = torch.Generator().manual_seed(7)
    batches = [data.batch_at(i) for i in range(n)]
    if cfg.is_encoder_decoder:
        for batch in batches:
            batch["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model),
                                          generator=gen).to(torch.bfloat16)
    return batches


def step_launches(cfg, n_steps):
    """The kernel launches of ``n_steps`` train steps under remat full: each
    layer's forward, its recompute and its backward. An encoder-decoder has
    no remat (nor has the reference's): a forward and a backward a layer,
    encoder and decoder."""
    if cfg.is_encoder_decoder:
        n = (cfg.n_layers + cfg.n_enc_layers) * n_steps
        return {"flash_attention": n, "flash_attention_bwd": n, "rglru_scan": 0,
                "rglru_scan_bwd": 0}
    kinds = cfg.pattern_for_layers()
    n_attn, n_rglru = kinds.count("attn"), kinds.count("rglru")
    return {"flash_attention": 2 * n_attn * n_steps, "flash_attention_bwd": n_attn * n_steps,
            "rglru_scan": 2 * n_rglru * n_steps, "rglru_scan_bwd": n_rglru * n_steps}


def check_step(label, got, plain, tol, failures):
    """A step's loss and grad norm through the kernels against the plain
    path's, each within ``tol`` relative."""
    for key in ("loss", "grad_norm"):
        rel = abs(got[key] - plain[key]) / abs(plain[key])
        ok = rel <= tol and math.isfinite(got[key])
        print(f"{label} {key}: kernels {got[key]:.6f}, plain {plain[key]:.6f}, relative "
              f"difference {rel:.2e} tol {tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} {key}: {got[key]} vs plain {plain[key]}")


def floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def step0(cfg, opt_cfg, fresh, batch, label, failures):
    """Step 0 on the plain versions (``force="ref"``) and through the
    kernels, from the same fresh state, the launch counts set to 0 just
    before the kernels' step and read just after (``step_launches``: 2
    forward and 1 backward flash launch an attention layer); the loss and
    grad norm within TRAIN_TOL, or TRAIN_TOL_FP32 in fp32. An MoE arch's
    kernels' step takes the plain step's routing choices, call by call
    (``routing``: each router's forward, then its recompute in the
    backward), and the choices it would have made itself are reported
    (``check_routing``, not gated). Returns (the kernels' metrics, the plain
    metrics, the launches)."""
    chosen, held = [], []
    with routing(record=chosen if cfg.is_moe else None):
        state, plain = steps.make_train_step(cfg, opt_cfg, force="ref")(fresh(), batch)
    plain = floats(plain)
    del state  # one full-width train state fills half the card
    gc.collect()
    torch.cuda.empty_cache()
    state = fresh()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with routing(pinned=[c for c, _ in chosen] if cfg.is_moe else None, own=held):
        state, got = steps.make_train_step(cfg, opt_cfg)(state, batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    got = floats(got)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    expect_launches(label, launches, step_launches(cfg, 1), failures)
    tol = TRAIN_TOL_FP32 if cfg.dtype == "float32" else TRAIN_TOL
    check_step(label + (" (routing pinned to the plain step's)" if cfg.is_moe else ""), got,
               plain, tol, failures)
    if cfg.is_moe:
        check_routing(cfg, f"{label}, router calls forward then recompute", "pinned", held,
                      chosen, False, failures)
    return got, plain, launches


def check_train_routing(cfg, params0, batch, device, failures):
    """The fp32 routing of a train batch, gated as ``check_routing`` gates
    serving's: the weights in fp32 through the eval step (the train-mode
    forward and loss, no grad) on the plain versions, recorded, then through
    the kernels (the fp32 flash route) with the routing pinned to those
    choices and with its own. At most ROUTE_FLIP_LIMIT of the choices may
    move; in the pinned run only at plain-path gaps within ROUTE_GAP_TOL of
    a tie. Returns the metrics."""
    cfg32 = cfg.replace(dtype="float32")
    params = tree_map_with_path(lambda _, t: t.to(device, torch.float32), params0)
    chosen, held, own = [], [], []
    with routing(record=chosen):
        plain = floats(steps.make_eval_step(cfg32, force="ref")(params, batch))
    with routing(pinned=[c for c, _ in chosen], own=held):
        pinned = floats(steps.make_eval_step(cfg32)(params, batch))
    with routing(record=own):
        free = floats(steps.make_eval_step(cfg32)(params, batch))
    del params
    torch.cuda.empty_cache()
    print(f"{cfg.name} train batch in fp32, loss through the kernels against the plain path: "
          f"pinned {pinned['loss']:.7f}, own routing {free['loss']:.7f}, plain "
          f"{plain['loss']:.7f} (aux {pinned['aux']:.7f} / {free['aux']:.7f} / {plain['aux']:.7f})")
    out = {"fp32_loss": {"pinned": pinned["loss"], "own": free["loss"], "plain": plain["loss"]}}
    label = f"train batch B{TRAIN_BATCH} S{TRAIN_SEQ}, true fan-in, fp32"
    out.update(check_routing(cfg, label, "pinned", held, chosen, True, failures))
    out.update(check_routing(cfg, label, "own routing", [c for c, _ in own], chosen, True,
                             failures))
    return out


def phase_train_fp32(failures):
    """The fp32 flash routes' train path: one smollm-360m train step at full
    width in fp32 (the same seeded true-fan-in weights and first batch as
    its bf16 train phase) through the kernels against the plain versions
    (``step0``: 64 forward and 32 backward flash launches, all on the fp32
    routes since every input is fp32, loss and grad norm within
    TRAIN_TOL_FP32). It is the one full-width path through the model's
    entry points that launches the fp32 backward route. Returns the
    launches."""
    t_phase = time.perf_counter()
    cfg = get_config("smollm-360m").replace(dtype="float32")
    batch = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)).batch_at(0)
    _, fresh = fresh_states(cfg, torch.device("cuda"))
    _, _, launches = step0(cfg, adamw.AdamWConfig(**TRAIN_OPT), fresh, batch,
                           "smollm-360m fp32 train step 0 (the fp32 backward route's main path)",
                           failures)
    print(f"smollm-360m fp32 train phase: {time.perf_counter() - t_phase:.1f} s "
          "(weights, the plain step and the kernels' step)")
    return launches


def fp32_batch():
    """(the largest batch at TRAIN_SEQ whose dry-run peak for recurrentgemma-2b's
    fp32 train step leaves TRAIN_FP32_FREE of the card free, {batch:
    predicted peak bytes}), searched one batch at a time from
    TRAIN_FP32_BATCH (``dryrun.run_cell``, meta tensors, no mesh)."""
    limit = (1 - TRAIN_FP32_FREE) * dryrun.HBM_BYTES
    peaks = {}

    def fits(b):
        peaks[b] = dryrun.run_cell(RG_ARCH, overrides={"dtype": "float32"}, mesh_shape=(),
                                   shape=ShapeConfig("chip_train_fp32", TRAIN_SEQ, b,
                                                     "train"))["peak_bytes"]
        return peaks[b] <= limit

    b = TRAIN_FP32_BATCH
    if fits(b):
        while fits(b + 1):
            b += 1
    else:
        while b > 1 and not fits(b - 1):
            b -= 1
        b -= 1
    return b, peaks


def phase_train_fp32_d256(failures):
    """recurrentgemma-2b's fp32 training at full width: the path of the fp32
    flash backward at head_dim 256 and of the scan's backward (26 layers,
    d_model 2560, 10 heads on 1 KV head, vocab 256,000, remat full, the
    true-fan-in weights of ``fresh_states`` in fp32, deterministic
    algorithms) through ``steps.make_train_step``, at the batch that
    ``fp32_batch`` sizes with the dry-run. Step 0 against the plain step
    (``step0``, within TRAIN_TOL_FP32: 16 + 8 flash and 36 + 18 scan
    launches); 2 steps counted and timed, their peak device memory against
    the dry-run's prediction (within DRYRUN_PEAK_TOL); one profiled step.
    Returns (step 0's launches, the 2 steps' launches, metrics)."""
    t_phase = time.perf_counter()
    device = torch.device("cuda")
    deterministic(device)
    b, peaks = fp32_batch()
    print(f"{RG_ARCH} fp32 train: batch {b} at S{TRAIN_SEQ}, the largest whose dry-run peak "
          f"leaves {100 * TRAIN_FP32_FREE:.0f}% of {dryrun.HBM_BYTES / 1e9:.0f} GB free; "
          "predicted peaks "
          + ", ".join(f"B{k} {v / 1e9:.3f} GB" for k, v in sorted(peaks.items()))
          + f" ({time.perf_counter() - t_phase:.1f} s)")
    if b < 1:
        failures.append(f"{RG_ARCH} fp32 train: no batch fits, dry-run peaks {peaks}")
        none = {name: 0 for name in ops.launch_counts()}
        return none, none, {"predicted_peak_bytes": peaks}
    cfg = get_config(RG_ARCH).replace(dtype="float32")
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    batches = [SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, b, seed=0)).batch_at(i)
               for i in range(3)]
    _, fresh = fresh_states(cfg, device)
    label = f"{RG_ARCH} fp32 train step 0 B{b} S{TRAIN_SEQ} (the fp32 backward at head_dim 256)"
    got, plain, launches0 = step0(cfg, opt_cfg, fresh, batches[0], label, failures)

    step_fn = steps.make_train_step(cfg, opt_cfg)
    state = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s, losses = [], []
    for batch in batches[:2]:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(f"{RG_ARCH} fp32 train (2 steps, remat full)", launches,
                    step_launches(cfg, 2), failures)
    state, wall_ms, busy_ms, by_name, _ = profile_step(step_fn, state, batches[2])
    del state
    shares = kernel_shares(by_name)
    peak_err = abs(peaks[b] - peak) / peak
    out = {"batch": b, "predicted_peak_bytes": peaks, "peak_bytes": peak,
           "peak_rel_err": peak_err, "step0": {k: got[k] for k in ("loss", "grad_norm")},
           "plain_step0": {k: plain[k] for k in ("loss", "grad_norm")}, "losses": losses,
           "step_ms": 1e3 * step_s[1], "first_step_ms": 1e3 * step_s[0],
           "tokens_per_s": b * TRAIN_SEQ / step_s[1], "profiled_step_wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms, "kernel_ms": shares}
    ok = peak_err <= DRYRUN_PEAK_TOL
    print(f"{RG_ARCH} fp32 train B{b} S{TRAIN_SEQ} remat full: step {out['step_ms']:.2f} ms "
          f"(step 2; first {out['first_step_ms']:.2f} ms), {out['tokens_per_s']:,.0f} tok/s, "
          f"peak device memory {peak / 1e9:.3f} GB ({peak / 2**30:.2f} GiB) against the "
          f"dry-run's {peaks[b] / 1e9:.3f} GB ({100 * peak_err:.2f}%, tol "
          f"{100 * DRYRUN_PEAK_TOL:.0f}% {'ok' if ok else 'FAIL'}); profiled step wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms ({100 * out['busy_share']:.1f}%); of it "
          + ", ".join(f"{k} {t:.2f} ms" for k, t in shares.items()) + f"; losses {losses}; "
          f"{card_line()}")
    if not ok:
        failures.append(f"{RG_ARCH} fp32 train peak {peak} vs the dry-run's {peaks[b]}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{RG_ARCH} fp32 train phase: {out['phase_s']:.1f} s")
    return launches0, launches, out


def kernel_shares(by_name):
    """Device ms of a profiled step's kernels by the port's kernel: the
    flash forward, the flash backward, the scan and the scan's backward."""
    shares = {"flash_fwd": 0.0, "flash_bwd": 0.0, "rglru_scan": 0.0, "rglru_scan_bwd": 0.0}
    for name, (t, _) in by_name.items():
        if "rglru_scan_bwd_kernel" in name:
            shares["rglru_scan_bwd"] += t
        elif "rglru_scan_kernel" in name:
            shares["rglru_scan"] += t
        elif BWD_KERNEL.search(name):
            shares["flash_bwd"] += t
        elif "flash_fwd" in name:
            shares["flash_fwd"] += t
    return shares


def host_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def phase_train_full_width(arch, failures):
    """One arch's training at full width (smollm-360m: 32 layers;
    recurrentgemma-2b: 26 layers, 18 rglru + 8 local attention, list layout;
    qwen2.5-3b: 36 layers, QKV bias; granite-moe-3b-a800m: 32 layers, the
    MoE FFN; stacked where the config says), remat full, bf16, the weights
    of ``fresh_states``, deterministic algorithms, through
    ``steps.make_train_step``, which updates the state in place (two fp32
    optimizer states would not fit the card), on B x S = TRAIN_BATCH x
    TRAIN_SEQ tokens of the synthetic stream. Step 0 against the same step
    on the plain versions (``step0``; an MoE arch's fp32 routing on the same
    batch gated first, before any train state is on the card);
    TRAIN_STEPS steps (xlstm-125m: XLSTM_TRAIN_STEPS, its host-bound steps
    take 7-12 s each) with the launch counts set to 0 just before and read
    just after (``step_launches``); the same steps again from the same seed
    must end on bit-equal state (the first run's kept in host memory); one
    more step under the profiler. whisper-tiny trains on B x WHISPER_SEQ
    tokens and bf16 frames (``train_batches``), with no remat (the
    reference's encoder-decoder has none). Returns (launches, metrics)."""
    t_phase = time.perf_counter()
    device = torch.device("cuda")
    deterministic(device)
    cfg = get_config(arch)
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    seq = WHISPER_SEQ if cfg.is_encoder_decoder else TRAIN_SEQ
    remat = "no remat" if cfg.is_encoder_decoder else "remat full"
    n = XLSTM_TRAIN_STEPS if arch == XLSTM else TRAIN_STEPS
    batches = train_batches(cfg, seq, TRAIN_BATCH, n + 1)
    params0, fresh = fresh_states(cfg, device)
    print(f"{arch} train: seeded weights on the host in {time.perf_counter() - t_phase:.1f} s")
    step_fn = steps.make_train_step(cfg, opt_cfg)
    out = {}
    if cfg.is_moe:
        out.update(check_train_routing(cfg, params0, batches[0], device, failures))
    if any(step_launches(cfg, 1).values()):  # a path with no kernel has no plain twin
        got, plain, _ = step0(cfg, opt_cfg, fresh, batches[0], f"{arch} train step 0", failures)
        out["step0"] = {k: got[k] for k in ("loss", "grad_norm", "aux")}
        out["plain_step0"] = {k: plain[k] for k in ("loss", "grad_norm")}

    state = fresh()
    n_params = sum(t.numel() for _, t in tree_flatten_with_paths(state.params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, step_s = [], []
    ops.reset_launch_counts()
    for batch in batches[:n]:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(floats(m))
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    expect_launches(f"{arch} train ({n} steps, {remat})", launches, step_launches(cfg, n),
                    failures)
    print(f"{arch} train losses {[round(m['loss'], 6) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 6) for m in metrics]}, aux "
          f"{[round(m['aux'], 6) for m in metrics]}, lr {[m['lr'] for m in metrics]}")

    host_gib = host_available_gib()
    kept = [(p, t.to("cpu", copy=True)) for p, t in tree_flatten_with_paths(state)]
    kept_gib = sum(t.numel() * t.element_size() for _, t in kept) / 2**30
    del state
    gc.collect()
    torch.cuda.empty_cache()
    again = fresh()
    for batch in batches[:n]:
        again, _ = step_fn(again, batch)
    torch.cuda.synchronize()
    flat = tree_flatten_with_paths(again)
    same = [p for p, _ in flat] == [p for p, _ in kept] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y) for (_, x), (_, y) in zip(flat, kept))
    del kept, flat
    print(f"{arch} train: two runs of {n} steps from the same seed "
          f"{'equal bit for bit' if same else 'DIFFER'} (params, m, v, master, step; the "
          f"first run's {kept_gib:.2f} GiB kept on the host, which had {host_gib:.1f} GiB "
          f"available before)")
    if not same:
        failures.append(f"{arch} train: two runs from the same seed differ")

    t0 = time.perf_counter()
    again, wall_ms, busy_ms, by_name, parts = profile_step(step_fn, again,
                                                           batches[n])
    print(f"{arch} train: the profiled step took {time.perf_counter() - t0:.1f} s with the "
          "trace's processing")
    if arch in TRAIN_FULL_WIDTH:  # one more step, its ATen ops and kernel calls counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter = op_cost.OpCost()
        with counter:
            again, _ = step_fn(again, batches[0])
        torch.cuda.synchronize()
        out["executed"] = {"flops": counter.flops, "kernels": counter.kernels,
                           "peak_bytes": torch.cuda.max_memory_allocated()}
    del again
    shares = kernel_shares(by_name)
    n_kernels = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    step_ms = 1e3 * sum(step_s[1:]) / max(len(step_s) - 1, 1)
    out.update({
        "params": n_params, "step_ms": step_ms, "first_step_ms": 1e3 * step_s[0],
        "tokens_per_s": TRAIN_BATCH * seq / (step_ms / 1e3), "peak_mem_gib": peak_gib,
        "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "kernels_per_step": n_kernels, "kernel_ms": shares,
        "top_kernels_ms": {name[:60]: t for name, (t, _) in top},
        "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics],
        "host_available_gib": host_gib})
    print(f"{arch} train B{TRAIN_BATCH} S{seq} {remat} bf16 ({n_params:,} "
          f"params): step {step_ms:.2f} ms (steps 2-{n}; first {out['first_step_ms']:.2f} ms), "
          f"{out['tokens_per_s']:,.0f} tok/s, peak device memory {peak_gib:.2f} GiB; profiled "
          f"step wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * out['busy_share']:.1f}%); of it "
          + ", ".join(f"{k} {t:.2f} ms ({100 * t / busy_ms:.2f}%)" for k, t in shares.items())
          + f"; {n_kernels} kernels in the step")
    print(f"{arch} train device time by kernel (profiled step, top 8): "
          + "; ".join(f"{name[:60]} {t:.2f} ms ({c})" for name, (t, c) in top))
    if "slstm" in cfg.pattern_for_layers():
        out["parts"] = {label: {**t, "host_share": t["host_ms"] / wall_ms,
                                "device_share": t["device_ms"] / busy_ms}
                        for label, t in parts.items()}
        print(f"{arch} train, the profiled step by part (host time on the host's clock under "
              "the profiler, forward, recompute and backward; device time of the kernels "
              "they launched): " + "; ".join(
                  f"{label} host {t['host_ms']:.2f} ms ({100 * t['host_share']:.1f}% of the "
                  f"wall), device {t['device_ms']:.2f} ms ({100 * t['device_share']:.1f}% of "
                  "the busy time)" for label, t in out["parts"].items()))
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{arch} train phase: {out['phase_s']:.1f} s")
    return launches, out


def phase_dryrun(full_train, failures):
    """The dry-run's count (``launch.op_cost`` over ``launch.dryrun.run_cell``
    on meta tensors, no mesh, no process group) of each TRAIN_FULL_WIDTH
    arch's phase-7 train step (B8 x S512, remat full, bf16), held to that
    phase's run on the card: the predicted peak within DRYRUN_PEAK_TOL of
    ``torch.cuda.max_memory_allocated`` over one step (reset just before it),
    the meta FLOPs within DRYRUN_FLOPS_TOL of ``op_cost``'s count of that
    step executed through the real kernels; and the whole-step share
    ``mfu`` = FLOPs / (step time x 989 TFLOP/s) beside the card. Then the
    CLI on DRYRUN_CELLS, each in a process of its own (the fake process
    group cannot share a process with phase 8c's NCCL group), all started
    together before the counts and read after them: exit 0. Returns {arch:
    metrics}."""
    card = card_line()
    out = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cli(arch, cell, multi_pod):
        """(the CLI's run, its result, its wall seconds) on one cell."""
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", cell, "--out", tmp] + (["--multi-pod"] if multi_pod else [])
            t0 = time.perf_counter()
            run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                                 timeout=600)
            files = list(Path(tmp).glob("*.json"))
            return run, json.loads(files[0].read_text()) if files else None, \
                time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(DRYRUN_CELLS))
    runs = [pool.submit(cli, *c) for c in DRYRUN_CELLS]
    shape = ShapeConfig("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    for arch in TRAIN_FULL_WIDTH:
        executed, metrics = full_train[arch][1]["executed"], full_train[arch][1]
        t0 = time.perf_counter()
        res = dryrun.run_cell(arch, shape=shape, mesh_shape=())
        peak_err = abs(res["peak_bytes"] - executed["peak_bytes"]) / executed["peak_bytes"]
        flops_err = abs(res["flops_per_device"] - executed["flops"]) / executed["flops"]
        mfu = res["flops_per_device"] / (metrics["step_ms"] / 1e3 * PEAK_FLOPS["bf16"])
        out[arch] = {"trace_s": time.perf_counter() - t0, "predicted_peak_bytes": res["peak_bytes"],
                     "measured_peak_bytes": executed["peak_bytes"], "peak_rel_err": peak_err,
                     "meta_flops": res["flops_per_device"], "executed_flops": executed["flops"],
                     "flops_rel_err": flops_err, "step_ms": metrics["step_ms"], "mfu": mfu,
                     "meta_kernels": res["kernels"], "executed_kernels": executed["kernels"]}
        ok_peak, ok_flops = peak_err <= DRYRUN_PEAK_TOL, flops_err <= DRYRUN_FLOPS_TOL
        print(f"{arch} dry-run of the B{TRAIN_BATCH} S{TRAIN_SEQ} train step: peak predicted "
              f"{res['peak_bytes'] / 2**30:.3f} GiB, measured {executed['peak_bytes'] / 2**30:.3f} "
              f"GiB ({100 * peak_err:.2f}%, tol {100 * DRYRUN_PEAK_TOL:.0f}% "
              f"{'ok' if ok_peak else 'FAIL'}); FLOPs meta {res['flops_per_device']:.6e}, "
              f"executed {executed['flops']:.6e} (relative {flops_err:.2e}, tol "
              f"{DRYRUN_FLOPS_TOL} {'ok' if ok_flops else 'FAIL'}); mfu {mfu:.4f} at "
              f"{metrics['step_ms']:.2f} ms a step, {card}")
        if not ok_peak:
            failures.append(f"{arch} dry-run peak {res['peak_bytes']} vs measured "
                            f"{executed['peak_bytes']}")
        if not ok_flops:
            failures.append(f"{arch} dry-run FLOPs {res['flops_per_device']} vs executed "
                            f"{executed['flops']}")
    keys = ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
            "arg_bytes", "peak_bytes", "fits_80gb", "bottleneck", "trace_s")
    for (arch, cell, multi_pod), future in zip(DRYRUN_CELLS, runs):
        label = f"{arch} {cell} on {'2x16x16' if multi_pod else '16x16'}"
        run, res, wall_s = future.result()
        out[label] = {"rc": run.returncode, "wall_s": wall_s,
                      **{k: (res or {}).get(k) for k in keys}}
        print(f"dry-run CLI {label} (torch {torch.__version__}, a process of its own, "
              f"beside the others): rc {run.returncode} in {wall_s:.1f} s; "
              + ", ".join(f"{k} {(res or {}).get(k)}" for k in keys))
        if run.returncode != 0 or res is None:
            print(run.stdout[-3000:] + run.stderr[-3000:], file=sys.stderr)
            failures.append(f"dry-run CLI {label}: rc {run.returncode}")
    pool.shutdown()
    return out


def phase_tiny_train(failures):
    """The decoder-only archs that train only at their tiny configs on the
    card (their full widths' train states need 128 GB to 3.8 TB): one bf16
    and one fp32 step each through the kernels against the same step on the
    plain versions (``step0``: B4 x S64, remat full, true-fan-in weights; an
    MoE arch's routing pinned to the plain step's). The fp32 steps run the
    fp32 routes of the forward and the backward. Returns {"<arch> tiny train
    <dtype>": launches}."""
    device = torch.device("cuda")
    deterministic(device)
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    out = {}
    for arch in TINY_TRAIN_ARCHS:
        for dtype in ("bfloat16", "float32"):
            cfg = get_tiny_config(arch).replace(dtype=dtype)
            batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=0)).batch_at(0)
            label = f"{arch} tiny train {dtype}"
            out[label] = step0(cfg, opt_cfg, fresh_states(cfg, device)[1], batch, label,
                               failures)[2]
    return out


def platform_job(train, checkpoint_interval, crash_at=None, sim_jobs=0, arch=PLATFORM_ARCH,
                 device=None):
    """One real ``arch`` job through the port's own ``FfDLPlatform`` on
    ``device`` (None: the card, the platform's default): submitted with
    ``ApiClient.for_platform`` (the v1 API tier, persisted before the ack),
    picked up by the LCM, its
    gang placed by the scheduler, deployed by the guardian, which builds a
    ``TorchLearner``, and ticked until it and ``sim_jobs`` SimLearner gang
    jobs of a second tenant (quota 4 chips, each job 2 x 2 chips) end. With
    ``crash_at``, once the learner reaches that step its runtime is killed
    and its pod failed (as tests/test_torch_learner.py's ``run_job`` does),
    once, and the guardian restarts it from its newest checkpoint. Each
    ``checkpoint.save`` is timed; so is each tick in which the learner
    stepped. Returns a dict: the job's status, status history, restarts,
    the steps it resumed from, its learner's per-tick (step, loss) history
    (the last learner's), its final checkpoint's leaves (on the host),
    the store's stats, the timings, the sim jobs' statuses, every pod bound
    to a host and the events' counts by kind."""
    p = FfDLPlatform(n_hosts=4, chips_per_host=4, device=device)
    sims = []
    if sim_jobs:
        p.admission.register_tenant("batch", quota_chips=4)
        batch = ApiClient.for_platform(p, "batch")
        sims = [batch.submit(JobManifest(name=f"sim{i}", tenant="batch", n_learners=2,
                                         chips_per_learner=2, sim_duration=60))
                for i in range(sim_jobs)]
    c = ApiClient.for_platform(p, "train")
    j = c.submit(JobManifest(name="smoke", tenant="train", arch=arch, n_learners=1,
                             chips_per_learner=2, checkpoint_interval=checkpoint_interval,
                             train=train))
    saves, stepped = [], []
    save = ckpt.save

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        out = save(*args, **kwargs)
        saves.append(time.perf_counter() - t0)
        return out

    crashed, learner = False, None
    t_job = time.perf_counter()
    with patched({(ckpt, "save"): timed_save}):
        for _ in range(5000):
            g = p.guardians.get(j)
            rt = g.runtimes.get(0) if g is not None else None
            learner = rt if rt is not None else learner
            before = rt.step if rt is not None and rt.phase == "PROCESSING" else None
            n_saves, t0 = len(saves), time.perf_counter()
            p.tick()
            if before is not None and rt.step > before:
                torch.cuda.synchronize()
                stepped.append((time.perf_counter() - t0 - sum(saves[n_saves:]),
                                rt.step - before))
            if crash_at is not None and not crashed and rt is not None \
                    and rt.phase == "PROCESSING" and rt.step >= crash_at:
                rt.kill()
                p.cluster.fail_pod(g.pods[0].name)
                crashed = True
            if all(p.meta.get(job).status in TERMINAL for job in (j, *sims)):
                break
    wall_s = time.perf_counter() - t_job
    rec = p.meta.get(j)
    bucket = MountedBucket(p.objstore, "results")
    final = ckpt.latest_step(bucket, f"{j}/ckpt")
    leaves = ckpt.restore(bucket, f"{j}/ckpt", final)[0] if final is not None else {}
    kinds = {}
    for e in p.events.events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    return {"status": c.status(j).value, "history": [h[1] for h in c.status_history(j)],
            "restarts": rec.restarts, "crashed": crashed, "final_step": final,
            "resumed_from": [e.fields["step"] for e in p.events.of_kind("resume_from_checkpoint")],
            "losses": list(learner.loss_history) if learner is not None else [],
            "leaves": leaves, "store": dataclasses.asdict(p.objstore.stats), "saves_s": saves,
            "stepped": stepped, "wall_s": wall_s,
            "sims": [p.meta.get(job).status.value for job in sims],
            "placements": [(e.fields["pod"], e.fields["host"])
                           for e in p.events.of_kind("pod_bound")],
            "events": kinds}


def bit_equal(a, b) -> bool:
    return bool(a) and set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def check_platform_job(label, job, restarts, resumed_from, failures):
    """The gates of a platform job: COMPLETED, its status history through
    DEPLOYING, DOWNLOADING, PROCESSING and STORING in that order, its
    guardian restarts, the checkpoint step its restart resumed from."""
    hist = job["history"]
    in_order = all(s in hist for s in PIPELINE) and \
        [hist.index(s) for s in PIPELINE] == sorted(hist.index(s) for s in PIPELINE)
    ok = job["status"] == "COMPLETED" and in_order and job["restarts"] == restarts \
        and job["resumed_from"] == resumed_from and job["crashed"] == bool(restarts)
    print(f"{label}: {job['status']}, history {hist}, restarts {job['restarts']}, resumed "
          f"from {job['resumed_from']}, final checkpoint step {job['final_step']}, "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: {job['status']}, history {hist}, restarts "
                        f"{job['restarts']}, resumed from {job['resumed_from']}")


def phase_crash_resume(failures):
    """A tiny smollm-360m job through the port's FfDLPlatform on the card,
    crashed at step 30 of 60: the guardian restarts it, it resumes from the
    step-20 checkpoint and ends COMPLETED on the uninterrupted job's params,
    optimizer state and step, bit for bit; the uninterrupted job launches
    ``step_launches(cfg, 60)``. Returns those launches."""
    ops.reset_launch_counts()
    straight = platform_job(TINY_JOB, 20)
    launches = ops.launch_counts()
    resumed = platform_job(TINY_JOB, 20, crash_at=30)
    check_platform_job("smollm tiny platform job, uninterrupted", straight, 0, [], failures)
    check_platform_job("smollm tiny platform job, crashed at step 30", resumed, 1, [20],
                       failures)
    same = bit_equal(straight["leaves"], resumed["leaves"])
    print(f"crash-resume through the platform (smollm tiny, 60 steps, checkpoint every 20, "
          f"killed once at step 30 or the end of that tick): final state "
          f"{'equal bit for bit' if same else 'DIFFERS'} ({len(straight['leaves'])} leaves); "
          f"launches of the uninterrupted job {launches}")
    expect_launches("smollm tiny platform job (60 steps, remat full)", launches,
                    step_launches(get_tiny_config(PLATFORM_ARCH), 60), failures)
    if not (same and straight["final_step"] == resumed["final_step"] == 60):
        failures.append(f"crash-resume through the platform: bit-equal {same}, final steps "
                        f"{straight['final_step']} / {resumed['final_step']}")
    return launches


def phase_platform_fp32(failures):
    """recurrentgemma-2b's tiny config in fp32 at head_dim 256 (FP32_JOB's
    config overrides) as a job through the port's FfDLPlatform on the card:
    20 steps, a checkpoint at step 10, COMPLETED with its status history,
    its launches ``step_launches(cfg, 20)`` (the fp32 flash backward at
    head_dim 256 and the scan's backward among them), its final
    checkpoint at step 20; then the same job through the port's platform on
    the CPU: the same status history, and the card's per-tick losses within
    FP32_JOB_TOL (relative) of the CPU's. Returns (the card job's launches,
    metrics)."""
    cfg = get_tiny_config(RG_ARCH)
    for k, v in FP32_JOB["overrides"].items():
        cfg = cfg.replace(**{k: v})
    ops.reset_launch_counts()
    card = platform_job(FP32_JOB, FP32_JOB_CKPT, arch=RG_ARCH)
    launches = ops.launch_counts()
    cpu = platform_job(FP32_JOB, FP32_JOB_CKPT, arch=RG_ARCH, device="cpu")
    label = f"{RG_ARCH} tiny fp32 head_dim 256 platform job"
    check_platform_job(f"{label} on the card", card, 0, [], failures)
    check_platform_job(f"{label} on the CPU", cpu, 0, [], failures)
    expect_launches(f"{label} ({FP32_JOB['steps']} steps, remat full)", launches,
                    step_launches(cfg, FP32_JOB["steps"]), failures)
    rel = [abs(a - b) / abs(b) for (_, a), (_, b) in zip(card["losses"], cpu["losses"])]
    ok = bool(rel) and [s for s, _ in card["losses"]] == [s for s, _ in cpu["losses"]] and \
        max(rel) <= FP32_JOB_TOL and card["history"] == cpu["history"] and \
        card["final_step"] == cpu["final_step"] == FP32_JOB["steps"]
    print(f"{label}: per-tick losses card {card['losses']}, CPU {cpu['losses']}, relative "
          f"differences {[f'{r:.2e}' for r in rel]} (tol {FP32_JOB_TOL:g}); status histories "
          f"{'equal' if card['history'] == cpu['history'] else 'DIFFER'}; final checkpoint "
          f"steps {card['final_step']} / {cpu['final_step']}; wall {card['wall_s']:.1f} s on "
          f"the card, {cpu['wall_s']:.1f} s on the CPU {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: card losses {card['losses']} vs CPU {cpu['losses']}, "
                        f"histories {card['history']} / {cpu['history']}")
    return launches, {"losses_card": card["losses"], "losses_cpu": cpu["losses"],
                      "max_rel_diff": max(rel) if rel else None, "wall_s": card["wall_s"],
                      "cpu_wall_s": cpu["wall_s"], "saves_s": card["saves_s"]}


def bare_step_ms(cfg, train, n=4):
    """The mean wall time of steps 2..n of the platform job's own step
    (``TorchLearner``'s state, optimizer and data) run bare on the card,
    synchronized after each step."""
    device = torch.device("cuda")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=train["steps"])
    step_fn = steps.make_train_step(cfg, opt_cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, train["seq"], train["batch"],
                                  seed=train["seed"]))
    state = steps.init_train_state(cfg, train["seed"], device)
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        state, _ = step_fn(state, data.batch_at(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del state
    return 1e3 * sum(times[1:]) / (n - 1)


def phase_platform_full_width(full_step_ms, failures):
    """smollm-360m at full width and PLATFORM_LAYERS of its 32 layers
    (bf16, remat full, seeded weights) as a job through the port's
    FfDLPlatform on the card: 6 steps at B8 x S512, checkpoint every 3,
    beside two SimLearner gang jobs of a tenant over its quota. The job
    crashed once after its step-3 checkpoint resumes from step 3 and ends
    COMPLETED, bit-equal to the uninterrupted job (which checkpoints only at
    its end: its state does not depend on when it saves), each counted
    against ``step_launches``. A checkpoint is params x (2 + 4 + 4 + 4) B,
    about 1.2 GB on the host at 4 layers (87 M params; 5 GB at 32): only
    the uninterrupted job's final leaves are kept, and its platform is gone
    before the crashed job starts. Prints the object
    store's bytes and the wall time a step through the platform (its
    checkpoints' saves taken out; the learner draws each batch on the host
    inside it), tick by tick with each tick's steps, for both jobs, and
    its mean over the steps of every tick after the phase's first, beside
    the same step run bare at the same depth (``bare_step_ms``) and phase
    7's bare step at 32 layers. Returns ({path: launches}, metrics)."""
    cfg = get_config(PLATFORM_ARCH).replace(n_layers=PLATFORM_LAYERS)
    t_phase = time.perf_counter()
    bare_ms = bare_step_ms(cfg, FULL_JOB)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    straight = platform_job(FULL_JOB, 10**9, sim_jobs=2)
    launches = ops.launch_counts()
    check_platform_job("smollm-360m platform job, uninterrupted", straight, 0, [], failures)
    expect_launches("smollm-360m platform job (6 steps, remat full)", launches,
                    step_launches(cfg, FULL_JOB["steps"]), failures)
    leaves = straight.pop("leaves")
    ticks, saves_s = straight["stepped"], straight["saves_s"]
    del straight
    gc.collect()
    ops.reset_launch_counts()
    resumed = platform_job(FULL_JOB, FULL_JOB_CKPT, crash_at=FULL_JOB_CKPT, sim_jobs=2)
    crashed_launches = ops.launch_counts()
    check_platform_job("smollm-360m platform job, crashed after its step-3 checkpoint",
                       resumed, 1, [FULL_JOB_CKPT], failures)
    # the first learner ran one tick (steps_per_tick steps), its restart the
    # steps from the checkpoint to the end
    n_steps = 5 + FULL_JOB["steps"] - FULL_JOB_CKPT
    expect_launches(f"smollm-360m crashed platform job ({n_steps} steps)", crashed_launches,
                    step_launches(cfg, n_steps), failures)
    same = bit_equal(leaves, resumed["leaves"])
    n_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    del leaves
    resumed.pop("leaves")
    ticks += resumed["stepped"]
    saves_s += resumed["saves_s"]
    by_tick = [(round(1e3 * s / n, 2), n) for s, n in ticks]
    sample = sum(n for _, n in ticks[1:])
    step_ms = 1e3 * sum(s for s, _ in ticks[1:]) / sample if sample else float("nan")
    print(f"smollm-360m platform job (full width, {PLATFORM_LAYERS} layers, "
          f"B{FULL_JOB['batch']} S{FULL_JOB['seq']}, {FULL_JOB['steps']} steps, checkpoint every {FULL_JOB_CKPT}, crashed once): final "
          f"state {'equal bit for bit' if same else 'DIFFERS'} to the uninterrupted job's "
          f"({n_bytes / 1e9:.3f} GB of leaves on the host); sim jobs {resumed['sims']}; "
          f"placements {resumed['placements']}; events {resumed['events']}")
    print(f"smollm-360m platform job: the crashed job's object store {resumed['store']}; "
          f"checkpoint saves (uninterrupted, then crashed) {[round(t, 2) for t in saves_s]} s; "
          f"wall a step through the platform, saves taken out, by tick (ms a step, steps) "
          f"{by_tick}, over the {sample} steps after the phase's first tick {step_ms:.2f} ms, "
          f"beside the same step bare at {PLATFORM_LAYERS} layers {bare_ms:.2f} ms (phase 7's "
          f"bare step at 32 layers {full_step_ms:.2f} ms); the crashed job's wall "
          f"{resumed['wall_s']:.1f} s; card {card_line()}")
    over_quota = resumed["events"].get("over_quota_admit", 0)
    if not (same and resumed["sims"] == ["COMPLETED", "COMPLETED"] and over_quota >= 1):
        failures.append(f"smollm-360m platform job: bit-equal {same}, sim jobs "
                        f"{resumed['sims']}, over-quota admissions {over_quota}")
    print(f"smollm-360m platform phase: {time.perf_counter() - t_phase:.1f} s")
    return {"smollm-360m platform job": launches,
            "smollm-360m crashed platform job": crashed_launches}, {
        "step_ms_through_platform": step_ms, "steps_sampled": sample,
        "ms_a_step_by_tick": by_tick,
        "layers": PLATFORM_LAYERS, "bare_step_ms": bare_ms,
        "phase7_bare_step_ms_32_layers": full_step_ms, "saves_s": saves_s,
        "store": resumed["store"], "job_wall_s": resumed["wall_s"]}


# --------------------------------------------------------------------------
# phase 8c: the mesh
# --------------------------------------------------------------------------

def whole(t):
    """A DTensor gathered (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def all_dtensors(tree) -> bool:
    return all(isinstance(t, DTensor) for _, t in tree_flatten_with_paths(tree))


def mesh_train_run(cfg, env, fresh, batches, count):
    """The train steps of ``batches`` on ``env``'s mesh from a fresh state
    placed by ``steps.train_state_shardings`` (the params by their logical
    axes, the optimizer state by ZeRO-1): (state, metrics, step seconds,
    launches or None, whether every leaf was a DTensor, peak GiB)."""
    step_fn = steps.make_train_step(cfg, adamw.AdamWConfig(**TRAIN_OPT))
    with use_env(env):
        state = steps.place_tree(fresh(), steps.train_state_shardings(cfg, env))
        sharded = all_dtensors(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if count:
            ops.reset_launch_counts()
        metrics, step_s = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            metrics.append(floats(m))
        launches = ops.launch_counts() if count else None
    return state, metrics, step_s, launches, sharded, torch.cuda.max_memory_allocated() / 2**30


def mesh_train_full_width(env, unsharded, failures):
    """qwen2.5-3b at full width on the 1x1 mesh: the weights, batches and
    optimizer of its train phase (``phase_train_full_width``), bf16, remat
    full, B8 x S512, params and ZeRO-1 state as DTensors. Step 0 against
    the unsharded kernels' step 0 of that phase (``unsharded["step0"]``),
    loss and grad norm within TRAIN_TOL; TRAIN_STEPS steps counted from 0
    (the unsharded step's launches: two flash forwards and one backward an
    attention layer); the same steps again bit-equal; the step time and
    peak memory beside the unsharded phase's. Returns (launches, metrics)."""
    t_phase = time.perf_counter()
    cfg = get_config(MESH_ARCH)
    device = torch.device("cuda")
    batches = train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS)
    _, fresh = fresh_states(cfg, device)
    state, metrics, step_s, launches, sharded, peak = mesh_train_run(cfg, env, fresh,
                                                                     batches, True)
    label = f"{MESH_ARCH} train on the 1x1 mesh"
    if not sharded:
        failures.append(f"{label}: a train state leaf is not a DTensor")
    expect_launches(f"{label} ({TRAIN_STEPS} steps, remat full)", launches,
                    step_launches(cfg, TRAIN_STEPS), failures)
    want = unsharded.get("step0")
    if want is None:
        failures.append(f"{label}: no unsharded step 0 to hold step 0 to")
    else:
        check_step(f"{label} step 0 against the unsharded kernels' step 0", metrics[0], want,
                   TRAIN_TOL, failures)
        bits = all(metrics[0][k] == want[k] for k in ("loss", "grad_norm"))
        print(f"{label} step 0: loss and grad norm {'bit-equal to' if bits else 'differ from'} "
              "the unsharded step's")
    kept = [(p, whole(t).to("cpu", copy=True)) for p, t in tree_flatten_with_paths(state)]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    again, _, _, _, _, _ = mesh_train_run(cfg, env, fresh, batches, False)
    flat = [(p, whole(t)) for p, t in tree_flatten_with_paths(again)]
    same = [p for p, _ in flat] == [p for p, _ in kept] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y) for (_, x), (_, y) in zip(flat, kept))
    del again, flat, kept
    gc.collect()
    torch.cuda.empty_cache()
    if not same:
        failures.append(f"{label}: two runs of {TRAIN_STEPS} steps differ")
    step_ms = 1e3 * sum(step_s[1:]) / max(len(step_s) - 1, 1)
    out = {"step0": {k: metrics[0][k] for k in ("loss", "grad_norm")},
           "loss": [m["loss"] for m in metrics], "step_ms": step_ms,
           "first_step_ms": 1e3 * step_s[0], "peak_mem_gib": peak,
           "unsharded_step_ms": unsharded.get("step_ms"),
           "unsharded_peak_mem_gib": unsharded.get("peak_mem_gib"), "bit_equal_runs": same}
    print(f"{label}: two runs of {TRAIN_STEPS} steps {'equal bit for bit' if same else 'DIFFER'};"
          f" step {step_ms:.2f} ms (steps 2-{TRAIN_STEPS}; first {out['first_step_ms']:.2f} ms)"
          f", peak {peak:.2f} GiB; unsharded: step {out['unsharded_step_ms']} ms, peak "
          f"{out['unsharded_peak_mem_gib']} GiB; {time.perf_counter() - t_phase:.1f} s")
    return launches, out


def mesh_tiny_train(env, failures):
    """One bf16 and one fp32 step of each of MESH_TINY's tiny configs on the
    1x1 mesh against the same step unsharded, both through the kernels, the
    mesh step's launches counted from 0 (the scan's too): loss and grad
    norm within TRAIN_TOL and TRAIN_TOL_FP32. Returns {label: launches}."""
    device = torch.device("cuda")
    out = {}
    for arch in MESH_TINY:
        for dtype in ("bfloat16", "float32"):
            cfg = get_tiny_config(arch).replace(dtype=dtype)
            batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=0)).batch_at(0)
            _, fresh = fresh_states(cfg, device)
            _, plain = steps.make_train_step(cfg, adamw.AdamWConfig(**TRAIN_OPT))(fresh(), batch)
            _, got, _, launches, sharded, _ = mesh_train_run(cfg, env, fresh, [batch], True)
            label = f"{arch} tiny train {dtype} on the 1x1 mesh"
            if cfg.is_moe:
                ep, tp = moe.moe_branch(cfg.n_experts, 64, 1)
                label += f" ({'token' if tp else 'expert'}-parallel MoE, ep {ep})"
            if not sharded:
                failures.append(f"{label}: a train state leaf is not a DTensor")
            expect_launches(label, launches, step_launches(cfg, 1), failures)
            check_step(label + ", against the unsharded step", got[0], floats(plain),
                       TRAIN_TOL_FP32 if dtype == "float32" else TRAIN_TOL, failures)
            out[label] = launches
    return out


def mesh_serve(env, failures):
    """smollm-360m at full width: an unsharded engine, then
    ``ServeEngine(mesh="1x1")`` on its params without and with
    ``ctx_parallel``, each ``generate`` 8 x 512 -> MESH_SERVE_GEN counted
    from 0 (one flash launch a layer); the greedy tokens equal the unsharded
    engine's wherever its top-1 margin (teacher-forced to the first parting
    step) decides them; then the fp32 prefill's last logits on the mesh (32
    fp32 flash launches) within 1e-3 of the unsharded ones. Returns
    ({label: launches}, {label: fp32 launches}, metrics)."""
    base = ServeEngine(MESH_SERVE, tiny=False, seed=0, device="cuda")
    cfg = base.cfg
    b, s, gen = 8, 512, MESH_SERVE_GEN
    prompts = base.synthetic_prompts(b, s)
    want = base.generate(prompts, gen)["tokens"]
    launches, metrics = {}, {}
    for ctx in (False, True):
        label = f"{MESH_SERVE} serving on the 1x1 mesh" + (", ctx_parallel" if ctx else "")
        engine = ServeEngine(MESH_SERVE, tiny=False, seed=0, device="cuda", mesh="1x1",
                             ctx_parallel=ctx, params=base.params)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = engine.generate(prompts, gen)
        launches[label] = ops.launch_counts()
        expect_launches(label, launches[label], {"flash_attention": cfg.n_layers,
                                                 "rglru_scan": 0}, failures)
        toks = got["tokens"]
        parted = [t for t in range(gen) if not torch.equal(toks[:, t], want[:, t])]
        note = "equal to the unsharded engine's"
        if parted:
            t = parted[0]
            rows = (toks[:, t] != want[:, t]).nonzero().flatten()
            ctx_toks = torch.cat([prompts, want[:, :t]], dim=1).cuda()
            top2 = last_logits(cfg, base.params, ctx_toks, None).float().topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1])[rows.cuda()]
            decided = bool((margin > 2 * LOGITS_TOL[torch.bfloat16]).any())
            note = (f"parting at step {t} in rows {rows.tolist()}, unsharded top-1 margins "
                    f"there {[round(float(m), 4) for m in margin]}")
            if decided:
                failures.append(f"{label}: tokens part from the unsharded engine's where its "
                                f"margin decides them ({note})")
        metrics[label] = {"decode_ms_per_token": got["decode_s"] / (gen - 1) * 1e3,
                          "prefill_ms": got["prefill_s"] * 1e3, "tokens_parted_at": parted[:1]}
        print(f"{label}: generate B{b} S{s} -> {gen}: prefill {got['prefill_s'] * 1e3:.2f} ms, "
              f"decode {metrics[label]['decode_ms_per_token']:.3f} ms/token; tokens {note}")
        del engine
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map_with_path(lambda _, t: t.float(), base.params)
    tokens = prompts.cuda()
    plain = last_logits(cfg32, p32, tokens, None)
    with torch.no_grad(), use_env(env):
        pp = steps.place_tree(p32, param_shardings(steps.param_axes(cfg32), p32, env))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _, _, last = steps.make_prefill_step(cfg32)(pp, shard_batch({"tokens": tokens}, env,
                                                                    tokens.device))
        fp32_launches = {f"{MESH_SERVE} fp32 prefill on the 1x1 mesh": ops.launch_counts()}
        last = whole(last)
    err = float((last - plain).abs().max())
    tol = LOGITS_TOL[torch.float32]
    print(f"{MESH_SERVE} fp32 prefill last logits on the 1x1 mesh against unsharded: max abs "
          f"err {err:.3e} tol {tol} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        failures.append(f"{MESH_SERVE} fp32 last logits on the mesh: {err}")
    expect_launches(f"{MESH_SERVE} fp32 prefill on the 1x1 mesh",
                    next(iter(fp32_launches.values())), {"flash_attention": cfg.n_layers},
                    failures)
    metrics["fp32_last_logits_max_abs_err"] = err
    return launches, fp32_launches, metrics


def mesh_serve_whisper(failures):
    """whisper-tiny at full width: an unsharded engine, then
    ``ServeEngine(mesh="1x1")`` on its params, each ``generate`` B8 ->
    MESH_WHISPER_GEN counted from 0 (one flash launch an encoder layer: the
    encode; decode launches none). Both draw the same frames (each engine's
    first draw from its seed); the greedy tokens equal the unsharded
    engine's wherever its top-1 margin (the decoder teacher-forced to the
    first parting step, over the same frames) decides them. Returns
    ({label: launches}, metrics)."""
    base = ServeEngine(WHISPER, tiny=False, seed=0, device="cuda")
    cfg = base.cfg
    b, s, gen = 8, 16, MESH_WHISPER_GEN
    prompts = torch.zeros((b, s), dtype=torch.long)  # an encoder-decoder reads only the shape
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    want = base.generate(prompts, gen)["tokens"]
    plain_launches = ops.launch_counts()
    label = f"{WHISPER} serving on the 1x1 mesh"
    engine = ServeEngine(WHISPER, tiny=False, seed=0, device="cuda", mesh="1x1",
                         params=base.params)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = engine.generate(prompts, gen)
    launches = ops.launch_counts()
    expect_launches(label, launches, {"flash_attention": cfg.n_enc_layers, "rglru_scan": 0},
                    failures)
    if launches != plain_launches:
        failures.append(f"{label}: launches {launches}, unsharded {plain_launches}")
    toks = got["tokens"]
    parted = [t for t in range(gen) if not torch.equal(toks[:, t], want[:, t])]
    note = "equal to the unsharded engine's"
    if parted:
        t = parted[0]
        rows = (toks[:, t] != want[:, t]).nonzero().flatten()
        top2 = last_logits(cfg, base.params, want[:, :t].cuda(), None,
                           frames=whisper_frames(cfg, b, 0)).float().topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1])[rows.cuda()]
        note = (f"parting at step {t} in rows {rows.tolist()}, unsharded top-1 margins there "
                f"{[round(float(m), 4) for m in margin]}")
        if bool((margin > 2 * LOGITS_TOL[torch.bfloat16]).any()):
            failures.append(f"{label}: tokens part from the unsharded engine's where its margin "
                            f"decides them ({note})")
    metrics = {"decode_ms_per_token": got["decode_s"] / (gen - 1) * 1e3,
               "tokens_parted_at": parted[:1]}
    print(f"{label}: generate B{b} x {cfg.enc_seq} frames -> {gen}: decode "
          f"{metrics['decode_ms_per_token']:.3f} ms/token; tokens {note}; launches "
          f"{launches['flash_attention']} (unsharded {plain_launches['flash_attention']})")
    del engine, base
    return {label: launches}, metrics


def mesh_checkpoints(env, failures):
    """A train state saved from the 1x1 mesh (DTensors: gathered, written,
    a barrier) restores unsharded, and one saved unsharded restores onto
    the mesh (``restore(like=, shardings=)``), each bit for bit:
    smollm-tiny after one step, on the card, in an in-memory store."""
    cfg = get_tiny_config("smollm-360m")
    device = torch.device("cuda")
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=0)).batch_at(0)
    state, _ = steps.make_train_step(cfg, adamw.AdamWConfig(**TRAIN_OPT))(
        steps.init_train_state(cfg, 0, device), batch)
    store = ObjectStore()
    store.create_bucket("ckpt")
    bucket = MountedBucket(store, "ckpt")
    like = steps.abstract_train_state(cfg)
    sh = steps.train_state_shardings(cfg, env)
    flat = dict(tree_flatten_with_paths(state))
    with use_env(env):
        ckpt.save(bucket, "mesh", 1, steps.place_tree(state, sh))
        back, _ = ckpt.restore(bucket, "mesh", 1, like=like)
        ckpt.save(bucket, "plain", 1, state)
        onto, _ = ckpt.restore(bucket, "plain", 1, like=like, shardings=sh)
    ok_back = all(not isinstance(t, DTensor) and torch.equal(t, flat[p].cpu())
                  for p, t in tree_flatten_with_paths(back))
    ok_onto = all_dtensors(onto) and all(torch.equal(whole(t).cpu(), flat[p].cpu())
                                         for p, t in tree_flatten_with_paths(onto))
    print(f"checkpoints, smollm tiny after a step: saved on the 1x1 mesh and restored unsharded "
          f"{'bit-equal' if ok_back else 'DIFFERENT'}; saved unsharded and restored onto the "
          f"mesh {'bit-equal' if ok_onto else 'DIFFERENT'} ({len(flat)} leaves)")
    if not (ok_back and ok_onto):
        failures.append(f"checkpoint round trip on the mesh: {ok_back}, {ok_onto}")


def phase_mesh(unsharded_qwen, failures):
    """The mesh: an NCCL process group of world size 1 (probed with an
    all-reduce and a barrier) and a 1x1 (data, model) mesh on the card;
    qwen2.5-3b's training at full width on it, MESH_TINY's tiny steps,
    smollm-360m's serving with and without ctx_parallel, whisper-tiny's
    serving, and the checkpoint round trip. Returns {"train": {label: launches},
    "train_fp32": {...}, "serve": {...}, "serve_fp32": {...}, "metrics":
    {...}}."""
    t_phase = time.perf_counter()
    device = torch.device("cuda")
    deterministic(device)
    world = init_process_group(device)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    dist.barrier()
    backend = dist.get_backend()
    print(f"mesh: process group backend {backend}, world size {world}, all-reduce of 1 gave "
          f"{float(probe)}")
    if backend != "nccl" or world != 1 or float(probe) != 1.0:
        failures.append(f"mesh: backend {backend}, world {world}, all-reduce {float(probe)}")
    out = {"train": {}, "train_fp32": {}, "serve": {}, "serve_fp32": {}, "metrics": {}}
    try:
        env = make_env(make_mesh((1, 1), ("data", "model"), "cuda"))
        launches, out["metrics"][f"{MESH_ARCH} train"] = mesh_train_full_width(
            env, unsharded_qwen, failures)
        out["train"][f"{MESH_ARCH} train on the 1x1 mesh"] = launches
        for label, n in mesh_tiny_train(env, failures).items():
            out["train_fp32" if "float32" in label else "train"][label] = n
        out["serve"], out["serve_fp32"], out["metrics"]["serve"] = mesh_serve(env, failures)
        whisper, out["metrics"]["serve_whisper"] = mesh_serve_whisper(failures)
        out["serve"].update(whisper)
        mesh_checkpoints(env, failures)
    finally:
        dist.destroy_process_group()
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 8e: FfDL's serving tier
# --------------------------------------------------------------------------

def dag_order(fed, tenant, stage_job):
    """The tenant's workload events on the workloads plane's bus, and
    whether they follow the Pipeline's DAG: the Pipeline applied, its train
    stage submitted, the stage's job completed, then its Service applied
    and scaled, in that order."""
    bus = [e for p in fed.shards for e in p.events.events if e.tenant == tenant]
    kinds = [(e.ts, e.kind) for e in bus if e.component == "workloads"]
    done = [e.ts for e in bus if e.kind == "job_completed" and e.fields.get("job") == stage_job]
    want = ["workload_applied", "workload_stage_submitted", "workload_applied",
            "workload_service_scaled"]
    at, i = [], 0
    for kind in want:
        while i < len(kinds) and kinds[i][1] != kind:
            i += 1
        at.append(i)
        i += 1
    ok = at[-1] < len(kinds) and bool(done) and kinds[at[1]][0] <= done[0] <= kinds[at[2]][0]
    return [k for _, k in kinds], ok


def phase_serving_tier(failures):
    """FfDL's serving path through the port's own control plane on the
    card: a two-shard ``Federation`` (its default device) with the operator
    installed, a tenant made by an ``AdminClient`` (a 4-chip quota and a
    rate limit), and its ``WorkloadClient``'s Pipeline: a real train stage
    (``SERVING_STAGE``, ``TorchLearner`` on the card), then a Service.
    Ticked until the stage is DONE and the Service RUNNING, with the launch
    counts set to 0 just before the apply and read just after. Then a
    full-width smollm-360m ``ServeEngine`` is attached to the Service and
    invoked through the workloads gateway, each invoke's launches counted
    from 0; the Service re-applied with 2 replicas, two more invokes must
    alternate between the slots. Each invoke's prefill and decode times
    come from a spy on the engine's ``generate``. Returns ({path:
    launches}, metrics)."""
    t_phase = time.perf_counter()
    tiny = get_tiny_config(PLATFORM_ARCH)
    fed = Federation(n_shards=2, n_hosts=2, chips_per_host=4, tick_period=5.0)
    install_operator(fed)
    admin = AdminClient.for_platform(fed)
    view = admin.create_tenant(SERVING_TENANT, quota_chips=4, rate=50.0, burst=20)
    client = WorkloadClient.for_platform(fed, tenant=SERVING_TENANT)
    service_spec = {"replicas": 1, "chips_per_replica": 1, "engine": "real",
                    "arch": PLATFORM_ARCH}
    pipeline = {"kind": "Pipeline", "name": "lm", "tenant": SERVING_TENANT,
                "stages": [{"name": "train", "job": SERVING_STAGE},
                           {"name": "serve", "after": ["train"], "service": service_spec}]}

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    client.apply(pipeline)
    service = None
    for n_ticks in range(1, 301):
        fed.tick()
        st = client.get("lm")["status"]
        stage, service = st["stages"]["train"], st["stages"]["serve"]["service"]
        if stage["state"] == "FAILED" or (
                stage["state"] == "DONE" and service
                and client.get(service)["status"]["phase"] == "RUNNING"):
            break
    torch.cuda.synchronize()
    stage_launches = ops.launch_counts()
    stage_s = time.perf_counter() - t0
    job = stage["job"]
    rec = fed.router.shard_for(SERVING_TENANT).platform.meta.get(job) if job else None
    status = rec.status.value if rec is not None else None
    kinds, in_order = dag_order(fed, SERVING_TENANT, job)
    print(f"serving tier: tenant {view['name']} (quota {view['quota_chips']} chips, rate "
          f"{view['rate']}/s burst {view['burst']}) on {fed.shard_of(SERVING_TENANT)}; "
          f"train stage {stage['state']}, its job {job} {status} after {n_ticks} ticks "
          f"({stage_s:.1f} s wall, card {card_line()}); service {service}; the tenant's "
          f"workload events {kinds} {'in the DAG order' if in_order else 'OUT OF ORDER'}")
    expect_launches(f"serving tier train stage ({SERVING_STAGE['train']['steps']} steps, "
                    "remat full)", stage_launches,
                    step_launches(tiny, SERVING_STAGE["train"]["steps"]), failures)
    if not (status == "COMPLETED" and stage["state"] == "DONE" and in_order and service
            and client.get(service)["status"]["phase"] == "RUNNING"):
        failures.append(f"serving tier: train stage {stage['state']}, job {status}, service "
                        f"{service}, events in order {in_order}")
        return {"serving tier train stage": stage_launches,
                "serving tier invokes": dict.fromkeys(stage_launches, 0)}, {"stage_s": stage_s}

    t0 = time.perf_counter()
    engine = ServeEngine(PLATFORM_ARCH, tiny=False, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fed.workloads.attach_engine(SERVING_TENANT, service, engine)
    times, invokes = [], []
    generate = engine.generate

    def timed(prompts, gen):
        out = generate(prompts, gen)
        times.append((out["prefill_s"], out["decode_s"]))
        return out

    B, S, gen = (SERVING_INVOKE[k] for k in ("batch", "prompt_len", "gen"))
    want = {"flash_attention": engine.cfg.n_layers, "flash_attention_bwd": 0,
            "rglru_scan": 0, "rglru_scan_bwd": 0}
    total = dict.fromkeys(want, 0)

    def invoke(n_replicas):
        label = f"serving tier invoke {len(invokes) + 1} ({n_replicas} replica(s))"
        ops.reset_launch_counts()
        out = client.invoke(service, payload=SERVING_INVOKE)  # an ApiError fails the script
        launches = ops.launch_counts()
        for k in total:
            total[k] += launches[k]
        expect_launches(label, launches, want, failures)
        toks = out["output"]["tokens"]
        if len(toks) != gen or not all(0 <= t < engine.cfg.vocab_size for t in toks):
            failures.append(f"{label}: bad tokens {toks}")
        prefill_s, decode_s = times[-1]
        m = {"replica": out["replica"], "job": out["job"], "prefill_ms": 1e3 * prefill_s,
             "prefill_ms_a_token": 1e3 * prefill_s / (B * S),
             "decode_ms_a_token": out["output"]["decode_ms_per_token"],
             "decode_s": decode_s}
        invokes.append(m)
        print(f"{label}: replica {m['replica']} (job {m['job']}), B{B} S{S} -> {gen}: prefill "
              f"{m['prefill_ms']:.2f} ms ({1e3 * m['prefill_ms_a_token']:.3f} us a token of "
              f"{B * S}), decode {m['decode_ms_a_token']:.3f} ms a token (a step of {B}); "
              f"card {card_line()}")

    with patched({(engine, "generate"): timed}):
        for _ in range(SERVING_INVOKES[0]):
            invoke(1)
        client.apply({"kind": "Service", "name": service, "tenant": SERVING_TENANT,
                      **service_spec, "replicas": 2})
        for _ in range(60):
            fed.tick()
            st = client.get(service)["status"]
            if st["phase"] == "RUNNING" and len(st["ready_slots"]) == 2:
                break
        else:
            failures.append(f"serving tier: the service never had 2 ready replicas: {st}")
        for _ in range(SERVING_INVOKES[1]):
            invoke(2)
    slots = [m["replica"] for m in invokes[SERVING_INVOKES[0]:]]
    alternate = len(slots) == 2 and slots[0] != slots[1]
    if not alternate:
        failures.append(f"serving tier: the two-replica invokes went to {slots}")
    op = fed.operator.status_view()
    phase_s = time.perf_counter() - t_phase
    print(f"serving tier: engine built in {build_s:.1f} s; the two-replica invokes went to "
          f"slots {slots} ({'alternating' if alternate else 'NOT alternating'}); operator "
          f"decisions {[d['action'] for d in op['decisions']]}; phase {phase_s:.1f} s (wall); "
          f"card {card_line()}")
    del engine
    return {"serving tier train stage": stage_launches, "serving tier invokes": total}, {
        "stage_s": stage_s, "stage_ticks": n_ticks, "engine_build_s": build_s,
        "invokes": invokes, "phase_s": phase_s}


# --------------------------------------------------------------------------
# phase 8f: FfDL's wire
# --------------------------------------------------------------------------

def final_state(platform, job_id) -> dict:
    """The leaves of a job's final checkpoint in the platform's store."""
    bucket = MountedBucket(platform.objstore, "results")
    step = ckpt.latest_step(bucket, f"{job_id}/ckpt")
    return ckpt.restore(bucket, f"{job_id}/ckpt", step)[0] if step is not None else {}


def route_requests(metrics_text: str) -> dict:
    """{"METHOD /template": requests} of ``ffdl_http_requests_total``, over
    every status, from a /metrics exposition."""
    out = {}
    for m in re.finditer(r'^ffdl_http_requests_total\{route="([^"]+)",status="\d+"\} (\d+)$',
                         metrics_text, flags=re.MULTILINE):
        out[m.group(1)] = out.get(m.group(1), 0) + int(m.group(2))
    return out


def phase_wire(failures):
    """FfDL's wire on the card: the port's two-shard ``Federation`` (its
    default device) behind ``ApiHttpServer`` on 127.0.0.1, with a rate
    limit. An operator key creates the tenant over ``POST
    /v2/admin/tenants``; the tenant's ``HttpTransport`` submits a real job
    (``SERVING_STAGE``: smollm-360m's tiny config, 20 steps, trained by
    ``TorchLearner`` on the card) over ``POST /v1/jobs``, and the ``ffdl``
    CLI's ``logs --follow`` follows it on one SSE stream to its end while
    the main thread ticks the federation (each shard's tick under that
    shard's write lock, the locks ``server.lock`` takes). The job must end
    COMPLETED, its flash launches (counted from 0 at the submit) equal to
    ``step_launches``, its final state bit-equal to the same manifest's job
    run in-process through ``FfDLPlatform``. Then a Service applied over
    ``POST /v2/workloads``, a full-width smollm-360m ``ServeEngine`` (bf16,
    seed 0) attached, invoked WIRE_INVOKES times over ``POST
    /v2/workloads/{name}/invoke`` at ``SERVING_INVOKE``, each counted from 0
    (one flash launch a layer), its tokens equal to those of a second
    engine of the same seed given the same payloads in-process; and ``GET
    /metrics`` counts the requests of each route used. Returns ({path:
    launches}, metrics)."""
    t_phase = time.perf_counter()
    tiny = get_tiny_config(PLATFORM_ARCH)
    fed = Federation(n_shards=2, n_hosts=2, chips_per_host=4, tick_period=5.0)
    server = ApiHttpServer(fed, rate_limit=RateLimitConfig(rate=200.0, burst=100),
                           heartbeat_s=1.0)
    manifest = JobManifest(name="wire", tenant=WIRE_TENANT, **SERVING_STAGE)
    zero = {"flash_attention": 0, "flash_attention_bwd": 0, "rglru_scan": 0, "rglru_scan_bwd": 0}
    with server:
        transport = HttpTransport(server.base_url, timeout=60.0)
        admin = AdminClient(transport, fed.auth.issue_admin_key())
        view = admin.create_tenant(WIRE_TENANT, quota_chips=4)
        key = fed.auth.issue_key(WIRE_TENANT)
        shard = fed.router.shard_for(WIRE_TENANT).platform

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        job = transport.submit(key, SubmitRequest(manifest=manifest)).job_id
        followed, rc = io.StringIO(), {}

        def follow():
            with contextlib.redirect_stdout(followed):
                rc["rc"] = ffdl_cli.main(["--endpoint", server.base_url, "--key", key,
                                          "logs", job, "--follow"])

        follower = threading.Thread(target=follow)
        follower.start()
        for n_ticks in range(1, 301):
            fed.tick()
            if shard.meta.get(job).status in TERMINAL:
                break
        torch.cuda.synchronize()
        job_launches = ops.launch_counts()
        job_s = time.perf_counter() - t0
        follower.join(60)
        status = transport.status(key, job).status
        # a real learner logs only a resume or a fatal error, as the
        # reference's does: the stream's end frame is what the follow awaits
        lines = followed.getvalue().splitlines()
        streams, open_streams = server.streams_opened, server.streams_active
        print(f"wire: tenant {view['name']} on {view['shard']} created over POST "
              f"/v2/admin/tenants; job {job} submitted over POST /v1/jobs: {status} after "
              f"{n_ticks} ticks ({job_s:.2f} s wall, card {card_line()}); `ffdl logs "
              f"--follow` returned {rc.get('rc')} at the job's end, {len(lines)} lines on "
              f"{streams} SSE stream(s), {open_streams} still open")
        expect_launches(f"wire job ({SERVING_STAGE['train']['steps']} steps, remat full)",
                        job_launches, step_launches(tiny, SERVING_STAGE["train"]["steps"]),
                        failures)
        if not (status == "COMPLETED" and rc.get("rc") == 0 and streams == 1
                and open_streams == 0 and not follower.is_alive()):
            failures.append(f"wire job: {status}, follow exit {rc.get('rc')}, {streams} "
                            f"streams opened, {open_streams} open")
        wire_state = final_state(shard, job)
        p = FfDLPlatform(n_hosts=2, chips_per_host=4)
        j = ApiClient.for_platform(p, WIRE_TENANT).submit(manifest)
        p.run_until_terminal([j], max_sim_s=5000)
        same = bit_equal(wire_state, final_state(p, j))
        print(f"wire job's final state against the same manifest's job in-process "
              f"({p.meta.get(j).status.value}): {'bit-equal' if same else 'DIFFERENT'} "
              f"({len(wire_state)} leaves)")
        if not same:
            failures.append("wire job: final state differs from the in-process job's")
        del p

        workloads = WorkloadClient(transport, key)
        workloads.apply({"kind": "Service", "name": "lm", "tenant": WIRE_TENANT,
                         "replicas": 1, "chips_per_replica": 1, "engine": "real",
                         "arch": PLATFORM_ARCH})
        for _ in range(60):
            fed.tick()
            if fed.workloads.get(WIRE_TENANT, "lm")["status"]["phase"] == "RUNNING":
                break
        else:
            failures.append(f"wire: the service never ran: {workloads.get('lm')['status']}")
        engine = ServeEngine(PLATFORM_ARCH, tiny=False, seed=0, device="cuda")
        twin = ServeEngine(PLATFORM_ARCH, tiny=False, seed=0, device="cuda")
        fed.workloads.attach_engine(WIRE_TENANT, "lm", engine)
        times, invokes = [], []
        generate = engine.generate

        def timed(prompts, gen):
            out = generate(prompts, gen)
            times.append((out["prefill_s"], out["decode_s"]))
            return out

        B, S, gen = (SERVING_INVOKE[k] for k in ("batch", "prompt_len", "gen"))
        want = {**zero, "flash_attention": engine.cfg.n_layers}
        total = dict(zero)
        with patched({(engine, "generate"): timed}):
            for i in range(WIRE_INVOKES):
                label = f"wire invoke {i + 1}"
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                out = workloads.invoke("lm", payload=SERVING_INVOKE)
                wall_s = time.perf_counter() - t0
                launches = ops.launch_counts()
                for k in total:
                    total[k] += launches[k]
                expect_launches(label, launches, want, failures)
                mine = twin.infer(SERVING_INVOKE)["tokens"]
                toks = out["output"]["tokens"]
                if toks != mine:
                    failures.append(f"{label}: tokens {toks} over the wire, {mine} in-process")
                prefill_s, decode_s = times[-1]
                m = {"wall_ms": 1e3 * wall_s, "prefill_ms": 1e3 * prefill_s,
                     "decode_ms": 1e3 * decode_s,
                     "wire_ms": 1e3 * (wall_s - prefill_s - decode_s)}
                invokes.append(m)
                print(f"{label}: B{B} S{S} -> {gen}, {m['wall_ms']:.2f} ms over the wire: "
                      f"prefill {m['prefill_ms']:.2f} ms, decode {m['decode_ms']:.2f} ms, the "
                      f"rest {m['wire_ms']:.2f} ms ({100 * m['wire_ms'] / m['wall_ms']:.2f}%); "
                      f"tokens {'equal to' if toks == mine else 'DIFFERENT from'} the "
                      f"in-process engine's; card {card_line()}")
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.request("GET", "/metrics")
        counts = route_requests(conn.getresponse().read().decode())
        conn.close()
    want_routes = {"POST /v2/admin/tenants": 1, "POST /v1/jobs": 1,
                   "GET /v1/jobs/{job_id}/logs": 1, "POST /v2/workloads": 1,
                   "POST /v2/workloads/{name}/invoke": WIRE_INVOKES}
    print(f"wire: GET /metrics request counts {counts}")
    for route, n in want_routes.items():
        if counts.get(route, 0) < n:
            failures.append(f"wire: /metrics counts {counts.get(route, 0)} requests of "
                            f"{route}, want at least {n}")
    phase_s = time.perf_counter() - t_phase
    print(f"wire phase: {phase_s:.1f} s (wall); card {card_line()}")
    del engine, twin
    return {"wire job": job_launches, "wire invokes": total}, {
        "job_s": job_s, "job_ticks": n_ticks, "invokes": invokes, "routes": counts,
        "phase_s": phase_s}


def load_example(name):
    """``examples/torch_{name}.py`` of this checkout as a module."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_steps(name, launches, failures):
    """The train steps one example's flash launches on the card account
    for (0 for an example with no real job)."""
    per_step = step_launches(get_tiny_config(PLATFORM_ARCH), 1)
    if name not in EXAMPLE_JOBS:
        if any(launches.values()):
            failures.append(f"example {name}: launched {launches} with no real job")
        return 0
    n_steps = launches["flash_attention_bwd"] // per_step["flash_attention_bwd"]
    if launches != {k: n * n_steps for k, n in per_step.items()} \
            or n_steps < EXAMPLE_JOBS[name] \
            or (name == "quickstart" and n_steps != EXAMPLE_JOBS[name]):
        failures.append(f"example {name}: launches {launches}, not whole train steps "
                        f"({per_step} a step) of at least {EXAMPLE_JOBS[name]}")
    return n_steps


def phase_examples(failures):
    """The port's five examples (``examples/torch_*.py``) run in-process on
    the card: each ``main(args + ["--device", "cuda"])``, its transcript
    printed, its launches counted from 0 just before it and read just
    after, its wall time printed beside the card's name and power limit.
    Each example asserts its own outcome (every job COMPLETED; the chaos
    drill's real job after its restarts; ``train_e2e --quick``'s falling
    loss trail and its HALT and RESUME; the pipeline's Service answering 4
    invokes and scaled to 3 ready replicas), which ends the run after its
    transcript. The launches (``example_steps``) must be whole train steps:
    quickstart's exactly 40, the chaos drill's at least 80, train_e2e's at
    least 150; the multi-tenant demo, in-process and over HTTP, launches
    nothing. Returns ({path: launches}, metrics)."""
    launches, metrics = {}, {}
    for name, args in EXAMPLES:
        label = " ".join([f"torch_{name}", *args])
        mod = load_example(name)
        out = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:  # an example's own assertion ends the run, after its transcript
            with contextlib.redirect_stdout(out):
                result = mod.main([*args, "--device", "cuda"])
        finally:
            for line in out.getvalue().splitlines():
                print(f"  | {line}")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counted = ops.launch_counts()
        n_steps = example_steps(name, counted, failures)
        print(f"example {label}: {wall_s:.1f} s (wall), launches {counted}"
              + (f" ({n_steps} train steps)" if n_steps else "")
              + f", returned {json.dumps(result)}; card {card_line()}")
        metrics[label] = {"wall_s": wall_s, "train_steps": n_steps}
        if name in EXAMPLE_JOBS:
            launches[f"example {label}"] = counted
        del mod, result
        gc.collect()
    return launches, metrics


def check_witness(failures):
    """The port's lock-order witness after phases 8-8g: its acquisitions
    and edges on a line of their own; no cycle, and at least one
    acquisition (else the port's RWLock was not hooked)."""
    edges = {k: sorted(v) for k, v in sorted(lock_witness.snapshot().items())}
    cycle = lock_witness.find_cycle()
    print(f"lock-order witness over phases 8-8g: {lock_witness.acquisitions} acquisitions, "
          f"edges {json.dumps(edges)}, {'cycle ' + ' -> '.join(cycle) if cycle else 'acyclic'}")
    if cycle or lock_witness.acquisitions == 0:
        failures.append(f"lock-order witness: {lock_witness.acquisitions} acquisitions, "
                        f"cycle {cycle}")
    return {"acquisitions": lock_witness.acquisitions, "edges": edges}


def kernel_entry(name, source, replaces, launches, timings, primary, worst):
    """One entry of the {"kernels": [...]} line: the primary main-path
    shape's numbers, and every main-path shape under "shapes"."""
    row = timings[primary]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    extra = ("eager_ms", "eager_library_ms", "same_bytes_add_ms", "yardstick_addcmul_ms",
             "gb_s", "share_of_bound",
             "cuda_core_bound_ms", "cuda_core_bound_by", "sdpa_fwd_ms", "sdpa_fwd_bwd_ms",
             "kernel_split_ms", "split_sessions")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": row["max_abs_err"], "worst_case_max_abs_err": worst,
            **{k: row[k] for k in keys}, "shape": row["shape"],
            "shapes": {label: {"shape": t["shape"], "route": t["route"],
                               "max_abs_err": t["max_abs_err"],
                               **{k: t[k] for k in keys + extra if k in t}}
                       for label, t in timings.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on a "
              "CUDA card", file=sys.stderr)
        return 1
    # cuBLAS reads its workspace setting when it first runs in the process;
    # the train phases turn on deterministic algorithms, which need it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    failures = []

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args, failures)
        gc.collect()  # a phase's tensors caught in reference cycles go with it
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s (wall); device memory still "
              f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        return out

    phase("build", phase_build)
    flash_t, flash_worst = phase("flash", phase_flash)
    bwd_t, bwd_worst = phase("flash backward", phase_flash_bwd)
    phase("grad mode", phase_grad_mode)
    scan_t, scan_worst = phase("rglru scan", phase_rglru)
    scan_bwd_t, scan_bwd_worst = phase("rglru scan backward", phase_rglru_bwd)
    sm_launches, sm_fp32_launches, sm_metrics = phase("smollm-360m serving", phase_smollm)
    rg_launches, rg_fp32_launches, rg_metrics = phase("recurrentgemma-2b serving",
                                                      phase_recurrentgemma)
    decoders = {arch: phase(f"{arch} serving", phase_decoder, arch) for arch in FULL_WIDTH_ARCHS}
    xl_launches, xl_metrics = phase(f"{XLSTM} serving", phase_xlstm)
    wh_launches, wh_pf_launches, wh_fp32_launches, wh_metrics = phase(f"{WHISPER} serving",
                                                                      phase_whisper)
    tiny_launches = phase("tiny configs on the card", phase_tiny_archs)
    full_train = {arch: phase(f"{arch} train", phase_train_full_width, arch)
                  for arch in TRAIN_FULL_WIDTH}
    dryrun_metrics = phase("dry-run", phase_dryrun, full_train)
    xl_train_launches, xl_train = phase(f"{XLSTM} train", phase_train_full_width, XLSTM)
    xl_cpu = phase(f"{XLSTM} card against the CPU", phase_cpu_step, XLSTM)
    wh_train_launches, wh_train = phase(f"{WHISPER} train", phase_train_full_width, WHISPER)
    wh_cpu = phase(f"{WHISPER} card against the CPU", phase_cpu_step, WHISPER)
    fp32_train_launches = phase("smollm-360m fp32 train step", phase_train_fp32)
    rg_fp32_step0, rg_fp32_launches, rg_fp32_train = phase(f"{RG_ARCH} fp32 train",
                                                           phase_train_fp32_d256)
    # the port's lock-order witness on the port's RWLock, phases 8 to 8g
    lock_witness.install()
    learner_launches = phase("platform job crash-resume", phase_crash_resume)
    fp32_job_launches, fp32_job = phase(f"{RG_ARCH} fp32 platform job", phase_platform_fp32)
    platform_launches, platform_metrics = phase(
        "smollm-360m platform job", phase_platform_full_width,
        full_train["smollm-360m"][1]["step_ms"])
    tiny_train = phase("tiny configs train on the card", phase_tiny_train)
    mesh = phase("the mesh", phase_mesh, full_train[MESH_ARCH][1])
    serving_launches, serving_metrics = phase("serving tier", phase_serving_tier)
    wire_launches, wire_metrics = phase("wire", phase_wire)
    example_launches, example_metrics = phase("examples", phase_examples)
    witness_metrics = check_witness(failures)
    lock_witness.uninstall()
    tiny = {dtype: {p: n["flash_attention"] for p, n in tiny_launches.items() if p.endswith(dtype)}
            for dtype in ("float32", "bfloat16")}
    rg_train_launches = full_train["recurrentgemma-2b"][0]
    train_paths = {**{f"{arch} train": d[0] for arch, d in full_train.items()},
                   f"{WHISPER} train": wh_train_launches,
                   "smollm tiny platform job": learner_launches,
                   **platform_launches,
                   "serving tier train stage": serving_launches["serving tier train stage"],
                   "wire job": wire_launches["wire job"],
                   **example_launches,
                   **{p: n for p, n in tiny_train.items() if p.endswith("bfloat16")},
                   **mesh["train"]}
    fp32_train_paths = {"smollm-360m fp32 train step": fp32_train_launches,
                        f"{RG_ARCH} fp32 train step 0": rg_fp32_step0,
                        f"{RG_ARCH} fp32 train (2 steps)": rg_fp32_launches,
                        f"{RG_ARCH} tiny fp32 platform job": fp32_job_launches,
                        f"{WHISPER} fp32 train step": wh_cpu["launches"],
                        **{p: n for p, n in tiny_train.items() if p.endswith("float32")},
                        **mesh["train_fp32"]}
    mesh_scan = {p: n for p, n in {**mesh["train"], **mesh["train_fp32"]}.items()
                 if n["rglru_scan"]}
    fp32_scan = {p: n for p, n in fp32_train_paths.items() if n["rglru_scan"]}

    kernels = [
        kernel_entry("flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu",
                     "src/repro/kernels/flash_attention.py:36",
                     {"smollm-360m": sm_launches["flash_attention"],
                      "recurrentgemma-2b": rg_launches["flash_attention"],
                      **{arch: d[0]["flash_attention"] for arch, d in decoders.items()},
                      WHISPER: wh_launches["flash_attention"],
                      f"{WHISPER} prefill step": wh_pf_launches["flash_attention"],
                      **tiny["bfloat16"],
                      **{p: n["flash_attention"] for p, n in mesh["serve"].items()},
                      "serving tier invokes":
                          serving_launches["serving tier invokes"]["flash_attention"],
                      "wire invokes": wire_launches["wire invokes"]["flash_attention"],
                      **{p: n["flash_attention"] for p, n in train_paths.items()}},
                     flash_t[torch.bfloat16], "smollm B8 S512", flash_worst[torch.bfloat16]),
        # the fp32 route, launched by the fp32 prefills of check_logits and
        # the fp32 train steps
        kernel_entry("flash_attention_fp32", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:36",
                     {"smollm-360m fp32 prefill": sm_fp32_launches["flash_attention"],
                      "recurrentgemma-2b fp32 prefill": rg_fp32_launches["flash_attention"],
                      **{f"{arch} fp32 prefill": d[1]["flash_attention"]
                         for arch, d in decoders.items()},
                      f"{WHISPER} fp32 prefill step": wh_fp32_launches["flash_attention"],
                      **tiny["float32"],
                      **{p: n["flash_attention"] for p, n in mesh["serve_fp32"].items()},
                      **{p: n["flash_attention"] for p, n in fp32_train_paths.items()}},
                     flash_t[torch.float32], "smollm B8 S512", flash_worst[torch.float32]),
        kernel_entry("rglru_scan", "src/repro_torch/csrc/rglru.cu",
                     "src/repro/kernels/rglru.py:31",
                     {"recurrentgemma-2b": rg_launches["rglru_scan"],
                      "recurrentgemma-2b train": rg_train_launches["rglru_scan"],
                      **{p: n["rglru_scan"] for p, n in fp32_scan.items()},
                      **{p: n["rglru_scan"] for p, n in mesh_scan.items()}},
                     scan_t, "recurrentgemma B8 S512", scan_worst),
        # the scan's backward (the JAX package trains through autodiff of its
        # associative scan), launched by the recurrentgemma train path
        kernel_entry("rglru_scan_bwd", "src/repro_torch/csrc/rglru_bwd.cu",
                     "src/repro/kernels/rglru.py:31",
                     {"recurrentgemma-2b train": rg_train_launches["rglru_scan_bwd"],
                      **{p: n["rglru_scan_bwd"] for p, n in fp32_scan.items()},
                      **{p: n["rglru_scan_bwd"] for p, n in mesh_scan.items()}},
                     scan_bwd_t, "recurrentgemma train B8 S512", scan_bwd_worst),
        # the backward of the flash forward (the JAX package trains through
        # autodiff of the jnp twin of the TPU kernel it names): the bf16
        # route, launched by the train paths, and the fp32 route, launched by
        # the fp32 train steps
        kernel_entry("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                     "src/repro/kernels/flash_attention.py:36",
                     {p: n["flash_attention_bwd"] for p, n in train_paths.items()},
                     bwd_t[torch.bfloat16], "smollm train B8 S512", bwd_worst[torch.bfloat16]),
        kernel_entry("flash_attention_bwd_fp32", "src/repro_torch/csrc/flash_attention_bwd.cu",
                     "src/repro/kernels/flash_attention.py:36",
                     {p: n["flash_attention_bwd"] for p, n in fp32_train_paths.items()},
                     bwd_t[torch.float32], BWD_FP32[0], bwd_worst[torch.float32]),
    ]
    print(f"card: {card}; smollm-360m: {json.dumps(sm_metrics)}; "
          f"recurrentgemma-2b: {json.dumps(rg_metrics)}; "
          + "".join(f"{arch}: {json.dumps(d[2])}; " for arch, d in decoders.items()) +
          "".join(f"{arch} train: {json.dumps(d[1])}; " for arch, d in full_train.items()) +
          f"{XLSTM}: {json.dumps({**xl_metrics, 'launches': xl_launches})}; "
          f"{XLSTM} train: {json.dumps(xl_train)} "
          f"(launches {xl_train_launches}); {XLSTM} card against the CPU: {json.dumps(xl_cpu)}; "
          f"{WHISPER}: {json.dumps(wh_metrics)}; {WHISPER} train: {json.dumps(wh_train)}; "
          f"{WHISPER} card against the CPU: {json.dumps(wh_cpu)}; "
          f"the mesh: {json.dumps(mesh['metrics'])}; "
          f"{RG_ARCH} fp32 train: {json.dumps(rg_fp32_train)}; "
          f"{RG_ARCH} tiny fp32 platform job: {json.dumps(fp32_job)}; "
          f"smollm-360m platform job: {json.dumps(platform_metrics)}; "
          f"the serving tier: {json.dumps(serving_metrics)}; "
          f"the wire: {json.dumps(wire_metrics)}; "
          f"the examples: {json.dumps(example_metrics)}; "
          f"the lock-order witness: {witness_metrics['acquisitions']} acquisitions; "
          f"the dry-run: {json.dumps(dryrun_metrics)}; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
