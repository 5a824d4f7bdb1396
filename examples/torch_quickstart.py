"""Quickstart on the PyTorch port: submit jobs to FfDL and watch them run.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's copy of examples/quickstart.py: the same flow, manifests and
prints through ``repro_torch``'s own ``FfDLPlatform`` and ``ApiClient``;
the real job trains with ``TorchLearner`` on ``--device`` (the CUDA card by
default; without one it raises, and never falls back to the CPU).
``main`` asserts that both jobs COMPLETED and returns
``{"statuses": {job: final status}}``.
"""

import argparse

from repro_torch.api import ApiClient
from repro_torch.core import FfDLPlatform, JobManifest, JobStatus
from repro_torch.launch.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the real job trains (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    # a small cluster: 4 hosts x 4 chips
    platform = FfDLPlatform(n_hosts=4, chips_per_host=4, placement="pack",
                            device=args.device)
    platform.admission.register_tenant("demo-team", quota_chips=12)
    # every user-facing call goes through the v1 API tier with a
    # tenant-scoped key
    client = ApiClient.for_platform(platform, tenant="demo-team")

    # 1) a simulated job (what the scheduling benchmarks use)
    sim = client.submit(JobManifest(
        name="preprocessing-sim", tenant="demo-team",
        n_learners=2, chips_per_learner=2, sim_duration=120))

    # 2) a real PyTorch training job: tiny llama-family model, 40 steps
    train = client.submit(JobManifest(
        name="smollm-tiny-train", tenant="demo-team",
        n_learners=1, chips_per_learner=2,
        arch="smollm-360m", checkpoint_interval=20,
        train={"steps": 40, "batch": 4, "seq": 64, "lr": 1e-3}))

    print(f"submitted: {sim} (simulated), {train} (real training)")
    last = {}
    while True:
        platform.tick()
        for j in (sim, train):
            st = client.status(j)
            if last.get(j) != st:
                rec = platform.meta.get(j)
                print(f"[t={platform.clock.now():7.1f}s] {j} "
                      f"{st.value:12s} step={rec.progress_step}")
                last[j] = st
        if all(client.status(j) in (JobStatus.COMPLETED, JobStatus.FAILED)
               for j in (sim, train)):
            break

    print("\nstatus history of the training job:")
    for ts, status, msg in client.status_history(train):
        print(f"  {ts:8.1f}s  {status:12s} {msg}")

    print(f"\ncluster utilization now: {platform.cluster.utilization():.0%}")
    print(f"results in object store: "
          f"{platform.objstore.list('results', train)[:3]} ...")
    statuses = {j: client.status(j).value for j in (sim, train)}
    assert set(statuses.values()) == {"COMPLETED"}, statuses
    return {"statuses": statuses}


if __name__ == "__main__":
    main()
