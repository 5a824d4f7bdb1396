"""End-to-end run on the PyTorch port: train a ~100M-parameter model for
a few hundred steps THROUGH the platform, with a mid-run HALT/RESUME
(hyperparameter-workflow path, FfDL §3.8) and checkpoint-based recovery.

    PYTHONPATH=src python examples/torch_train_e2e.py              # ~100M, 300 steps, card
    PYTHONPATH=src python examples/torch_train_e2e.py --quick      # tiny, 150 steps
    PYTHONPATH=src python examples/torch_train_e2e.py --quick --steps 30 --device cpu

The port's copy of examples/train_e2e.py: the same job, HALT/RESUME and
prints through ``repro_torch``'s own ``FfDLPlatform`` and ``ApiClient``.
The job trains with ``TorchLearner`` on ``--device`` (the CUDA card by
default; without one it raises, and never falls back to the CPU); its
parameter count is read from the learner's train state. The model is a
smollm-family decoder sized to ~100M params; data is the deterministic
synthetic LM stream. Loss is reported from the learner's checkpoint
metadata trail. ``main`` asserts a falling trail, the HALT/RESUME and the
job COMPLETED, and returns ``{"statuses": {job: final status}}`` with the
loss trail and the parameter count.
"""

import argparse

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.api import ApiClient
from repro_torch.core import FfDLPlatform, JobManifest, JobStatus
from repro_torch.data.objectstore import MountedBucket
from repro_torch.launch.serve import resolve_device
from repro_torch.utils.trees import tree_count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the job trains (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    steps = args.steps or (150 if args.quick else 300)
    overrides = (
        {} if args.quick else {
            # ~100M params: 12L x 768d x 12H(kv4), 16k vocab
            "n_layers": 12, "d_model": 768, "n_heads": 12, "n_kv_heads": 4,
            "d_ff": 2048, "vocab_size": 16384, "scan_layers": False,
            "attn_chunk": 64,
        })

    p = FfDLPlatform(n_hosts=2, chips_per_host=4, device=args.device)
    c = ApiClient.for_platform(p)
    j = c.submit(JobManifest(
        name="e2e-train", arch="smollm-360m", n_learners=1,
        chips_per_learner=4, checkpoint_interval=25,
        train={"steps": steps, "batch": 8, "seq": 128, "lr": 1.5e-3,
               "warmup": 10, "tiny": True, "overrides": overrides,
               "seed": 0}))
    n_params = None
    halted = False
    print(f"submitted {j}: ~100M-param decoder, {steps} steps")
    while c.status(j) not in (JobStatus.COMPLETED, JobStatus.FAILED):
        p.tick()
        rec = p.meta.get(j)
        g = p.guardians.get(j)
        if g and g.runtimes.get(0) is not None and n_params is None:
            rt = g.runtimes[0]
            if getattr(rt, "_state", None) is not None:
                n_params = tree_count(rt._state.params)
                print(f"model materialized: {n_params/1e6:.1f}M params")
        if rec.status == JobStatus.PROCESSING and rec.progress_step and \
                rec.progress_step % 50 < 5 and g and g.runtimes.get(0):
            hist = getattr(g.runtimes[0], "loss_history", [])
            if hist:
                print(f"  step {hist[-1][0]:4d}  loss {hist[-1][1]:.4f}")
        # demonstrate HALT/RESUME mid-run (the hyperparameter workflow)
        if not halted and rec.status == JobStatus.PROCESSING \
                and rec.progress_step >= steps // 3:
            print(f"-> HALT at step {rec.progress_step} "
                  "(checkpoint + free chips)")
            c.halt(j)
            halted = True
        if halted and rec.status == JobStatus.HALTED:
            print(f"-> chips free: {p.cluster.used_chips} in use; RESUME")
            c.resume(j)
            halted = "resumed"

    print(f"\nfinal status: {c.status(j).value}")
    bucket = MountedBucket(p.objstore, "results")
    trail = []
    for s in ckpt.steps_available(bucket, f"{j}/ckpt"):
        _, meta = ckpt.restore(bucket, f"{j}/ckpt", s, like=None)
        if "loss" in meta:
            trail.append((s, meta["loss"]))
    print("loss trail from checkpoints:")
    for s, l in trail:
        print(f"  step {s:4d}  loss {l:.4f}")
    if len(trail) >= 2:
        assert trail[-1][1] < trail[0][1], "loss did not decrease!"
        print(f"loss decreased {trail[0][1]:.3f} -> {trail[-1][1]:.3f}  OK")
    hist = [s for _, s, _ in c.status_history(j)]
    assert "HALTED" in hist and "RESUMED" in hist
    print("HALT/RESUME exercised through the status pipeline  OK")
    assert c.status(j) == JobStatus.COMPLETED, c.status(j)
    return {"statuses": {j: c.status(j).value}, "trail": trail, "n_params": n_params}


if __name__ == "__main__":
    main()
