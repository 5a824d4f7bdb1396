"""One run of one cell: set-up, the measured window or the profiled one, and
the comparison with the plain reference that decides ``correct``.

The timed entry is the port's ``models.steps.make_train_step``, driven as
the port's learner (``core.executor.TorchLearner.tick``) drives it: one host
batch a step from the traffic's generator, the step consuming its state,
and one host sync (``float(loss)``) every ``steps_per_sync`` steps. Set-up
builds one train state from the seeded weights and drives it through the
first group of steps; the first ``checked_steps`` of them are what the
reference follows. The same state then runs the window: whole groups until
``--seconds`` have passed, ending on a group's sync.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name (README.md).
"""

from __future__ import annotations

import gc
import importlib.util
import inspect
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from bench import data as bench_data
from bench import flops as bench_flops
from bench import trace as bench_trace
from bench.weights import draw, gather, kind_of_path, kinds, port_path, sample_index

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
E2E = ("train_tokens_per_s", "train_mfu_pct", "train_peak_gib", "setup_s")
NUMBERS = ("loss_gap", "grad_norm_gap", "grad_leaf_gap", "grad_sample_gap", "update_leaf_gap")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# pieces of a leaf summed at once in float64, in elements
PIECE = 1 << 26


def _cells(entries, cell):
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_spec(workload: str) -> dict:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, limits
    and metric entries, each read from its own file."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = _cells(bench["end_to_end"], workload)
    unknown = [m["name"] for m in e2e if m["name"] not in E2E]
    if unknown:
        raise SystemExit(f"the harness takes no end-to-end metric {unknown}")
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in _cells(bench["per_layer"], workload) if m["moves"] in reported]
    return {"name": workload, "chips": cell["chips"],
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((BENCH / "workloads" / f"{workload}.json").read_text())["limits"],
            "end_to_end": [m["name"] for m in e2e],
            "per_layer": {m["name"]: m["unit"] for m in per_layer}}


# -------------------------------------------------------------------------
# the program's side
# -------------------------------------------------------------------------

def port_config(config: dict):
    """The port's ModelConfig of a configuration file: its arch's config at
    the file's widths, depth and dtype. Raises where the port cannot run what
    the file states."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm, steps
    from repro_torch.nn import layers

    w = bench_flops.dims(config)
    cfg = get_config(config["arch"]).replace(
        n_layers=w["layers"], d_model=w["d"], n_heads=w["h"], n_kv_heads=w["kv"],
        head_dim=config.get("head_dim", 0), vocab_size=w["vocab"],
        rope_theta=float(config["rope_theta"]), tie_embeddings=config["tie_word_embeddings"],
        dtype=config["torch_dtype"])
    if w["experts"]:
        cfg = cfg.replace(n_experts=w["experts"], top_k=w["top_k"], moe_d_ff=w["ff"],
                          capacity_factor=config["capacity_factor"])
    else:
        cfg = cfg.replace(d_ff=w["ff"], n_experts=0, top_k=0)
    stated = {
        "a pure attention stack": cfg.block_pattern == ("attn",),
        "global causal attention": cfg.local_window == 0 and cfg.use_rope,
        "no QKV bias or QK-norm": not cfg.qkv_bias and not cfg.qk_norm
        and not config["attention_bias"],
        "RMSNorm at rms_norm_eps": cfg.rms_norm and math.isclose(
            inspect.signature(layers.rmsnorm).parameters["eps"].default, config["rms_norm_eps"]),
        "hidden_act": cfg.act == config["hidden_act"],
        "tied embeddings": cfg.tie_embeddings,
        "z_loss": math.isclose(
            inspect.signature(lm.cross_entropy).parameters["z_loss"].default, config["z_loss"]),
        "router_aux_loss_coef": math.isclose(steps.AUX_WEIGHT, config["router_aux_loss_coef"]),
    }
    off = [k for k, ok in stated.items() if not ok]
    if off:
        raise ValueError(f"the port does not run {config['arch']} as its file states: {off}")
    return cfg


def build_state(cfg, config: dict, seed: int, device):
    """The port's TrainState of the seeded weights, laid out in the tree
    ``steps.abstract_params`` describes."""
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

    want = dict(tree_flatten_with_paths(steps.abstract_params(cfg)))
    leaves = {}
    for kind in kinds(config):
        flat, path = draw(config, kind, seed, device), port_path(config, kind)
        like = want.pop(path, None)
        if like is None or like.dtype != flat.dtype or math.prod(like.shape) != flat.numel():
            raise ValueError(f"the port's leaf {path} is not the benchmark's: {like}")
        leaves[path] = flat.view(like.shape)
    if want:
        raise ValueError(f"the port has leaves the benchmark does not draw: {sorted(want)}")
    params = tree_unflatten(leaves)
    return steps.TrainState(torch.zeros((), dtype=torch.int32, device=device), params,
                            adamw.init(params))


def sumsq(t) -> float:
    """The float64 sum of squares of a tensor, a piece at a time."""
    return sum(float(torch.sum(torch.square(p.double()))) for p in t.reshape(-1).split(PIECE))


def by_kind(config: dict, tree) -> dict:
    """{kind: leaf} of a port tree (the params' or an optimizer state's)."""
    from repro_torch.utils.trees import tree_flatten_with_paths
    return {kind_of_path(config, path): t for path, t in tree_flatten_with_paths(tree)}


def checked_steps(step_fn, state, feed, n: int, config: dict, opt: dict, seed: int):
    """The first n steps through the window's own call and feed; returns the
    state and the program's readings (the reference's ``train`` documents
    each). The first clipped gradient is worked out from the first moment
    after one step, (1 - beta1) times it."""
    losses, first = [], {}
    for step in range(n):
        state, metrics = step_fn(state, feed(step))
        losses.append(metrics["loss"])
        if step == 0:
            m = by_kind(config, state.opt.m)
            first = {"grad_norm": float(metrics["grad_norm"]),
                     "grad": {k: math.sqrt(sumsq(t)) / (1 - opt["beta1"]) for k, t in m.items()},
                     "grad_sample": {k: (gather([t], sample_index(config, k, seed, t.device))
                                         / (1 - opt["beta1"])).cpu() for k, t in m.items()}}
    delta = {}
    for kind, master in by_kind(config, state.opt.master).items():
        w0 = draw(config, kind, seed, master.device)
        delta[kind] = math.sqrt(sum(
            float(torch.sum(torch.square((a - b.float()).double())))
            for a, b in zip(master.reshape(-1).split(PIECE), w0.split(PIECE))))
        del w0
    return state, {"loss": [float(x) for x in losses], **first, "delta": delta}


def run_groups(step_fn, state, feed, start: int, groups: int, per_group: int):
    """``groups`` groups of steps, each ending on the learner's sync."""
    step = start
    for _ in range(groups):
        for _ in range(per_group):
            state, metrics = step_fn(state, feed(step))
            step += 1
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at step {step}")
    return state, step


# -------------------------------------------------------------------------
# the comparison
# -------------------------------------------------------------------------

def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """{number: {"value", "limit", "at"}} of the numbers ``limits`` names:
    each step's loss; the first step's global gradient norm; each kind's
    first clipped gradient and change over the checked steps, by the worst
    kind, each gap relative to the reference's norm of that kind or of the
    median kind, whichever is larger (kinds whose reference gradient is
    under a thousandth of the median kind's left out of the change); and
    the first clipped gradient's elements at each kind's sampled indices,
    the norm of their difference over the reference's, by the worst kind."""
    def gap(a, b, base):
        return abs(a - b) / base if base > 0 else (0.0 if a == b else math.inf)

    def sample_gap(kind):
        p, r = prog["grad_sample"].get(kind), ref["grad_sample"][kind]
        if p is None or p.shape != r.shape:
            return math.inf
        return gap(float(torch.linalg.vector_norm(p - r)), 0.0, float(torch.linalg.vector_norm(r)))

    med_g = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_d = statistics.median(ref["delta"][k] for k in moved)
    found = {
        "loss_gap": max((gap(p, r, abs(r)), f"step {i}")
                        for i, (p, r) in enumerate(zip(prog["loss"], ref["loss"]))),
        "grad_norm_gap": (gap(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"]), "global"),
        "grad_leaf_gap": max((gap(prog["grad"].get(k, math.inf), g, max(g, med_g)), k)
                             for k, g in ref["grad"].items()),
        "grad_sample_gap": max((sample_gap(k), k) for k in ref["grad_sample"]),
        "update_leaf_gap": max((gap(prog["delta"].get(k, math.inf), ref["delta"][k],
                                    max(ref["delta"][k], med_d)), k) for k in moved),
    }
    return {name: {"value": value, "limit": limits[name], "at": at}
            for name, (value, at) in found.items() if name in limits}


def judged(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def reference_readings(spec: dict, seed: int, device, quant=False, rows=None) -> dict:
    """The plain fp32 reference's readings over the checked steps, TF32 off;
    ``quant`` is the control, ``rows`` a batch cut to its first rows."""
    from bench.reference import model as ref

    torch.use_deterministic_algorithms(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = spec["config"], spec["traffic"]
    feed = bench_data.make(traffic, config["vocab_size"], seed)
    batches = [feed(i) for i in range(traffic["checked_steps"])]
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
    params = ref.init(config, seed, device)
    out = ref.train(params, batches, config, traffic["optimizer"], seed, quant=quant)
    del params
    free(device)
    return out


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# -------------------------------------------------------------------------
# one run
# -------------------------------------------------------------------------

def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             step_fn=None, log=print) -> tuple:
    """One run; returns the result line's object and, for each number
    compared, where it read worst. ``step_fn`` stands in for the port's
    train step (tests plant faults there)."""
    from repro_torch.launch.train import deterministic
    from repro_torch.models import steps
    from repro_torch.optim import adamw

    config, traffic = spec["config"], spec["traffic"]
    cuda = device.type == "cuda"
    deterministic(device)  # before the first product on the card, as the learner
    if cuda:
        torch.empty(1, device=device)  # the context, before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    cfg = port_config(config)
    opt = traffic["optimizer"]
    step_fn = step_fn or steps.make_train_step(cfg, adamw.AdamWConfig(**opt))
    feed = bench_data.make(traffic, config["vocab_size"], seed)
    per_group = traffic["steps_per_sync"]
    n_checked = traffic["checked_steps"]
    tokens_per_step = traffic["batch"] * traffic["seq"]

    state = build_state(cfg, config, seed, device)
    state, prog = checked_steps(step_fn, state, feed, n_checked, config, opt, seed)
    state, step = run_groups(step_fn, state, feed, n_checked, 1, per_group - n_checked)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.3f} s; checked losses {prog['loss']}")

    flops_per_step = bench_flops.train_flops_per_token(config, traffic["seq"]) * tokens_per_step
    peak_flops = bench_flops.PEAK_FLOPS[bench_flops.PEAK_KIND[config["torch_dtype"]]]
    metrics, result_device, breakdown = {}, {}, None
    if trace:
        groups = traffic["trace_groups"]
        (state, step), record = bench_trace.profile(
            lambda: run_groups(step_fn, state, feed, step, groups, per_group), device)
        n_steps = groups * per_group
        lo, hi = record["window_ns"]
        ctx = {"record": record, "steps": n_steps, "config": config, "traffic": traffic,
               "flops_per_step": flops_per_step, "peak_flops": peak_flops}
        for name, unit in spec["per_layer"].items():
            value = load_metric(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        result_device = {"busy_s": bench_trace.busy_ns(record) / 1e9, "window_s": (hi - lo) / 1e9}
        breakdown = {"device_ops": bench_trace.top_device_ops(record),
                     "idle_gaps": bench_trace.idle_gaps(record)}
        del record, ctx
    else:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        n_steps = 0
        while True:
            state, step = run_groups(step_fn, state, feed, step, 1, per_group)
            n_steps += per_group
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        rate = n_steps * tokens_per_step / elapsed
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        values = {"train_tokens_per_s": (rate, "tokens/s"),
                  "train_mfu_pct": (100 * rate * flops_per_step / tokens_per_step / peak_flops, "%"),
                  "train_peak_gib": (peak / 2 ** 30, "GiB"), "setup_s": (setup_s, "s")}
        metrics = {name: {"value": values[name][0], "unit": values[name][1]}
                   for name in spec["end_to_end"]}
        log(f"window {elapsed:.3f} s, {n_steps} steps")
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del state
    free(device)

    ref = reference_readings(spec, seed, device)
    checks = compare(prog, ref, spec["limits"])
    out = {"correct": judged(checks), "attempted": n_steps, "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": spec["chips"], "memory_peak_bytes": memory_peak, **result_device}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}
    return out, {name: c["at"] for name, c in checks.items()}


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level modules this process holds (or ``modules``
    names), compared by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))
