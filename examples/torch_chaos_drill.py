"""Chaos drill on the PyTorch port: a fleet of jobs (including real
training) rides out learner crashes, node failures, and guardian/controller
crashes (FfDL §3.8, §5.6).

    PYTHONPATH=src python examples/torch_chaos_drill.py                # on the card
    PYTHONPATH=src python examples/torch_chaos_drill.py --device cpu

The port's copy of examples/chaos_drill.py: the same chaos seed, fleet and
prints through ``repro_torch``'s own ``FfDLPlatform``; the real job trains
with ``TorchLearner`` on ``--device`` (the CUDA card by default; without
one it raises, and never falls back to the CPU). ``main`` asserts that
every job COMPLETED and returns ``{"statuses": {job: final status}}`` with
the real job's restarts.
"""

import argparse
from collections import Counter

from repro_torch.api import ApiClient
from repro_torch.core import ChaosConfig, FfDLPlatform, JobManifest
from repro_torch.launch.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the real job trains (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    chaos = ChaosConfig(
        seed=7,
        p_learner_crash=0.004,
        p_host_fail=0.001,
        p_guardian_crash=0.002,
        p_controller_crash=0.003,
        host_recovery_s=90.0,
    )
    p = FfDLPlatform(n_hosts=8, chips_per_host=4, chaos=chaos, seed=3,
                     device=args.device)
    c = ApiClient.for_platform(p)

    jobs = [c.submit(JobManifest(name=f"sim-{i}", n_learners=2,
                                 chips_per_learner=2, sim_duration=300,
                                 max_restarts=20))
            for i in range(5)]
    jobs.append(c.submit(JobManifest(
        name="real-train", arch="smollm-360m", n_learners=1,
        chips_per_learner=2, checkpoint_interval=15, max_restarts=20,
        train={"steps": 80, "batch": 4, "seq": 64})))

    print(f"running {len(jobs)} jobs under chaos "
          f"(learner/host/guardian/controller faults enabled)...")
    ok = p.run_until_terminal(jobs, max_sim_s=50000)

    print("\n--- outcome ---")
    statuses = Counter(c.status(j).value for j in jobs)
    print(f"job outcomes: {dict(statuses)}")
    assert ok and statuses.get("COMPLETED", 0) == len(jobs), statuses

    print("\n--- what chaos did (event log) ---")
    for kind in ("learner_killed", "host_killed", "guardian_crashed",
                 "controller_killed", "pod_evicted", "node_notready"):
        print(f"  {kind:20s} {p.events.count(kind)}")

    print("\n--- how the platform recovered ---")
    for kind in ("pod_restarted", "learners_replaced", "rollback",
                 "guardian_restarted", "resume_from_checkpoint"):
        print(f"  {kind:22s} {p.events.count(kind)}")

    print("\n--- recovery timeline of the real training job ---")
    j = jobs[-1]
    for ts, status, msg in c.status_history(j):
        print(f"  {ts:8.1f}s  {status:12s} {msg}")
    print(f"\nno leaked chips: {p.cluster.used_chips} in use  OK")
    return {"statuses": {job: c.status(job).value for job in jobs},
            "real_restarts": p.meta.get(j).restarts}


if __name__ == "__main__":
    main()
