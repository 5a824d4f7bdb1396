"""The readings each cell's correctness limits are set from, on the card at
the cell's own sizes, in one process (one set-up of the kernels):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --out <file.json>

For every seed: the program's checked steps, as a run's set-up drives them,
against the plain reference (the sound runs, the lower readings). For every
control seed also the control (the reference in fp8, put in the program's
place) and the faults a one-card training cell can have, planted in the
reference put in the program's place: half of the batch left out (the mean
taken over the rest), and one kind's change doubled (an answer altered
where it is produced). A state returned unchanged reads 1 on the change by
its definition and needs no run. Prints one JSON line a reading and writes
them all to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import data as bench_data  # noqa: E402
from bench import harness  # noqa: E402


def bare(readings):
    """The readings without the sampled gradient elements."""
    return {k: v for k, v in readings.items() if k != "grad_sample"}


def by_kind(prog, ref):
    """Each kind's sampled gradient gap (which kinds hold the worst)."""
    return {k: float(torch.linalg.vector_norm(prog["grad_sample"][k] - r)
                     / torch.linalg.vector_norm(r)) for k, r in ref["grad_sample"].items()}


def gaps(checks):
    return {name: [c["value"], c["at"]] for name, c in checks.items()}


def readings(spec: dict, seeds: list, controls: list, device, emit=print) -> list:
    """The readings of ``seeds`` and, with the control's and the faults',
    of ``controls`` (first, so that a fault in their path shows early)."""
    from repro_torch.launch.train import deterministic
    from repro_torch.models import steps
    from repro_torch.optim import adamw

    spec = {**spec, "limits": {k: float("inf") for k in harness.NUMBERS}}
    config, traffic = spec["config"], spec["traffic"]
    rows = []

    def out(row):
        emit(json.dumps(row))
        rows.append(row)

    for seed in list(controls) + [s for s in seeds if s not in controls]:
        deterministic(device)
        cfg = harness.port_config(config)
        step_fn = steps.make_train_step(cfg, adamw.AdamWConfig(**traffic["optimizer"]))
        feed = bench_data.make(traffic, config["vocab_size"], seed)
        t0 = time.time()
        state = harness.build_state(cfg, config, seed, device)
        state, prog = harness.checked_steps(step_fn, state, feed, traffic["checked_steps"],
                                            config, traffic["optimizer"], seed)
        t1 = time.time()
        del state
        harness.free(device)
        ref = harness.reference_readings(spec, seed, device)
        t2 = time.time()
        out({"seed": seed, "what": "program", "gaps": gaps(harness.compare(prog, ref, spec["limits"])), "kinds": by_kind(prog, ref),
             "program_s": t1 - t0, "reference_s": t2 - t1, "prog": bare(prog), "ref": bare(ref)})
        if seed not in controls:
            continue
        ctl = harness.reference_readings(spec, seed, device, quant=True)
        out({"seed": seed, "what": "control_fp8",
             "gaps": gaps(harness.compare(ctl, ref, spec["limits"])), "kinds": by_kind(ctl, ref),
             "control": bare(ctl)})
        half = harness.reference_readings(spec, seed, device, rows=traffic["batch"] // 2)
        out({"seed": seed, "what": "fault_half_batch",
             "gaps": gaps(harness.compare(half, ref, spec["limits"])), "half": bare(half)})
        for kind in ref["delta"]:
            doubled = {**ref, "delta": {**ref["delta"], kind: 2 * ref["delta"][kind]}}
            out({"seed": seed, "what": f"fault_double_{kind}",
                 "gaps": gaps(harness.compare(doubled, ref, spec["limits"]))})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    rows = readings(harness.load_spec(args.workload), [int(s) for s in args.seeds.split(",")],
                    [int(s) for s in args.control_seeds.split(",") if s], torch.device("cuda", 0),
                    emit=lambda line: print(line, flush=True))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
