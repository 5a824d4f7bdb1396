"""Declarative workloads end-to-end on the PyTorch port: apply a
train→eval→serve Pipeline manifest, let the reconciler converge it
unattended, then query the multi-tenant serving tier it materialized.

    PYTHONPATH=src python examples/torch_pipeline_e2e.py                # on the card
    PYTHONPATH=src python examples/torch_pipeline_e2e.py --device cpu

The port's copy of examples/pipeline_e2e.py: the same manifest
(examples/manifests/pipeline.yaml), ticks and prints through
``repro_torch``'s own ``Federation`` and ``WorkloadClient``, its shards'
real jobs on ``--device`` (the CUDA card by default; without one it
raises, and never falls back to the CPU). ``main`` asserts that the
pipeline SUCCEEDED, its Service answered the 4 invokes and scaled to 3
ready replicas, and returns ``{"statuses": {"lm-pipe": phase}}`` with the
replicas that answered and the ready slots.
"""

import argparse
import pathlib

from repro_torch.api import Federation, WorkloadClient
from repro_torch.launch.serve import resolve_device

MANIFEST = pathlib.Path(__file__).resolve().parent / "manifests" / \
    "pipeline.yaml"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where real jobs train (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    # tick_period=5 sim-seconds per tick so stage jobs clear the fixed
    # 30 s deploy/download phases in a handful of ticks
    fed = Federation(n_shards=2, n_hosts=2, chips_per_host=4,
                     tick_period=5.0, device=args.device)
    client = WorkloadClient.for_platform(fed, tenant="demo-team")

    view = client.apply(MANIFEST.read_text())
    print(f"applied {view['kind']}/{view['name']} "
          f"(generation {view['generation']})")

    seen = {}
    phase = None
    for tick in range(1, 201):
        fed.tick()
        status = client.get("lm-pipe")["status"]
        for stage, s in status["stages"].items():
            if seen.get(stage) != s["state"]:
                seen[stage] = s["state"]
                print(f"tick {tick:3d}: stage {stage:<6} -> {s['state']}"
                      + (f" ({s['job']})" if s["job"] else ""))
        if status["phase"] in ("SUCCEEDED", "DEGRADED"):
            phase = status["phase"]
            print(f"tick {tick:3d}: pipeline {status['phase']}")
            break

    svc = client.get("lm-pipe-serve")
    print(f"\nchild service: lm-pipe-serve phase={svc['status']['phase']} "
          f"ready={svc['status']['ready_slots']} "
          f"(owner {svc['owner']})")
    invokes = []
    for i in range(4):
        out = client.invoke("lm-pipe-serve", payload={"prompt": f"q{i}"})
        invokes.append(out)
        print(f"invoke {i}: replica {out['replica']} job {out['job']}")

    # scale the serving tier by editing replicas: and re-applying
    spec = svc["spec"]
    client.apply({"kind": "Service", "name": "lm-pipe-serve",
                  "tenant": "demo-team", **{
                      k: v for k, v in spec.items()
                      if k not in ("kind", "name", "tenant")},
                  "replicas": 3})
    for _ in range(60):
        fed.tick()
        if len(client.get("lm-pipe-serve")["status"]["ready_slots"]) == 3:
            break
    ready = client.get("lm-pipe-serve")["status"]["ready_slots"]
    print(f"\nscaled to replicas=3 by re-applying; ready slots: {ready}")

    # per-tenant usage now carries serving_replica_seconds for the tier
    meter = fed.router.shard_for("demo-team").platform.meter
    row = meter.snapshot().get("demo-team", {})
    print(f"serving_replica_seconds billed: "
          f"{row.get('serving_replica_seconds', 0.0):.0f}")
    assert phase == "SUCCEEDED" and len(ready) == 3 \
        and all(out.get("replica") is not None for out in invokes), (phase, invokes, ready)
    return {"statuses": {"lm-pipe": phase}, "replicas": [out["replica"] for out in invokes],
            "ready": ready}


if __name__ == "__main__":
    main()
