"""The port's declarative workloads (``repro_torch.workloads``: the
manifest parser and validator, the workloads plane and gateway, the
reconciler) against the reference's on the CPU.

Every scenario of tests/test_workloads.py runs on both packages from the
same seed through ``tests/_torch_mirror.py`` and must leave the same
trace: the wire responses of every gateway verb, each shard's event bus,
journal and job records, and each federation's workloads (specs and
status blocks) and the reconciler's decision journal. The property tests
run at the same fixed seeds on both.

Two scenarios reach the port's HTTP transport. One compares in call order
(test_workloads::test_http_rejects_cross_tenant_and_unknown_workload_routes);
test_workloads::test_workloads_over_http_with_qos_isolation compares as a
set (``_torch_mirror.mirror``'s ``order`` and ``ticked``), besides its own
assertions: a ticker thread runs the federation while it polls the Service
(``get_workload``) in a loop of its own, and a token bucket's refill on the
wall clock decides how many of the flooding tenant's invokes pass.

Then FfDL's serving path end to end through the port's own control plane:
a Pipeline whose train stage is a real tiny smollm-360m job on
``device="cpu"`` ends on the same train state as the same job through the
port's ``FfDLPlatform``, and its Service, with a port engine on the
reference's fp32 weights attached, answers invokes with the reference
``ServeEngine.generate``'s greedy tokens. A Federation on its default
device (the card) where there is none fails the real stage with the
learner's ``fatal:`` log and never trains on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mirror as mirror
from _torch_mirror import one_thread  # noqa: F401 (a fixture)
from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.api import ApiClient, Federation, WorkloadClient
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import FfDLPlatform, JobManifest, JobStatus
from repro_torch.core import executor as texecutor
from repro_torch.core import guardian as tguardian
from repro_torch.convert import params_from_numpy
from repro_torch.data.objectstore import MountedBucket
from repro_torch.launch import serve as tserve

MODULES = ("test_workloads",)
ORDER = {"test_workloads::test_workloads_over_http_with_qos_isolation": (
    "set", ["WorkloadGateway.get_workload"])}
SCENARIOS = [s for stem in MODULES for s in mirror.scenarios(stem)]


def test_waiting_scenarios_are_exactly_those_that_reach_http():
    assert [s for stem in MODULES for s in mirror.waiting(stem)] == []


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_leaves_the_same_trace_on_both_packages(scenario, monkeypatch, capsys):
    mirror.mirror(scenario, monkeypatch, capsys, *ORDER.get(scenario, ("strict", [])))


# --------------------------------------------------------------------------
# a real train stage, then a Service, through the port's Federation
# --------------------------------------------------------------------------

ARCH = "smollm-360m"
STAGE_JOB = {"n_learners": 1, "chips_per_learner": 1, "arch": ARCH,
             "checkpoint_interval": 10,
             "train": {"steps": 20, "batch": 4, "seq": 64, "seed": 3}}
PIPELINE = {"kind": "Pipeline", "name": "lm", "tenant": "team-a",
            "stages": [{"name": "train", "job": STAGE_JOB},
                       {"name": "serve", "after": ["train"],
                        "service": {"replicas": 1, "chips_per_replica": 1,
                                    "engine": "real", "arch": ARCH}}]}



def final_leaves(platform, job_id):
    bucket = MountedBucket(platform.objstore, "results")
    step = ckpt.latest_step(bucket, f"{job_id}/ckpt")
    leaves, meta = ckpt.restore(bucket, f"{job_id}/ckpt", step)
    return step, leaves, meta


@pytest.fixture(scope="module")
def pipeline(one_thread):
    """The Pipeline applied by the tenant's WorkloadClient on a two-shard
    port Federation on the CPU, ticked until its train stage is DONE and
    its Service RUNNING."""
    fed = Federation(n_shards=2, n_hosts=2, chips_per_host=4, tick_period=5.0, device="cpu")
    client = WorkloadClient.for_platform(fed, tenant="team-a")
    client.apply(PIPELINE)
    for _ in range(200):
        fed.tick()
        st = client.get("lm")["status"]
        service = st["stages"]["serve"]["service"]
        if service and client.get(service)["status"]["phase"] == "RUNNING":
            break
    else:
        pytest.fail(f"the pipeline never served: {client.get('lm')['status']}")
    return fed, client


def test_pipeline_stage_trains_as_the_platform_job(pipeline):
    """The train stage's job ends COMPLETED on the final state of the same
    manifest submitted to the port's FfDLPlatform, bit for bit."""
    fed, client = pipeline
    st = client.get("lm")["status"]
    assert st["stages"]["train"]["state"] == "DONE"
    job = st["stages"]["train"]["job"]
    shard = fed.router.shard_for("team-a").platform
    assert shard.meta.get(job).status == JobStatus.COMPLETED
    step, leaves, meta = final_leaves(shard, job)
    assert step == 20 and meta == {"final": True}

    p = FfDLPlatform(n_hosts=2, chips_per_host=4, device="cpu")
    j = ApiClient.for_platform(p, "team-a").submit(
        JobManifest(name="lm-train", tenant="team-a", **STAGE_JOB))
    assert p.run_until_terminal([j], max_sim_s=5000)
    assert p.meta.get(j).status == JobStatus.COMPLETED
    want_step, want, _ = final_leaves(p, j)
    assert want_step == step and set(leaves) == set(want)
    for path in want:
        assert leaves[path].dtype == want[path].dtype
        assert torch.equal(leaves[path], want[path]), path


def test_pipeline_events_follow_the_dag(pipeline):
    """The tenant's workload events: the Pipeline applied, its train stage
    submitted, then its Service applied and scaled."""
    fed, _ = pipeline
    kinds = [e.kind for p in fed.shards for e in p.events.events
             if e.tenant == "team-a" and e.component == "workloads"]
    order = ["workload_applied", "workload_stage_submitted", "workload_applied",
             "workload_service_scaled"]
    at = [kinds.index(k, kinds.index(order[i - 1]) + 1 if i else 0)
          for i, k in enumerate(order)]
    assert at == sorted(at), kinds


class OnPrompts:
    """An engine whose invokes carry their own prompts (``{"prompts":
    [[token, ...], ...], "gen": n}``), so both packages decode the same
    ones."""

    def __init__(self, engine):
        self.engine = engine

    def infer(self, payload):
        prompts = torch.tensor(payload["prompts"], dtype=torch.long)
        return {"tokens": self.engine.generate(prompts, payload["gen"])["tokens"].tolist()}


def test_service_invokes_answer_the_reference_greedy_tokens(pipeline, monkeypatch):
    """A tiny fp32 port engine on the reference's weights
    (``convert.params_from_numpy``), attached to the Service, answers each
    invoke with the reference ``ServeEngine.generate``'s greedy tokens on
    the same prompts."""
    fed, client = pipeline
    service = client.get("lm")["status"]["stages"]["serve"]["service"]
    for module, get in ((rconfigs, rconfigs.get_tiny_config),
                        (tserve, tserve.get_tiny_config)):
        monkeypatch.setattr(module, "get_tiny_config",
                            lambda arch, get=get: get(arch).replace(dtype="float32"))
    ref = rserve.ServeEngine(ARCH, tiny=True)
    flat = {p: np.asarray(x) for p, x in jflatten(ref.params)}
    port = tserve.ServeEngine(ARCH, tiny=True, device="cpu",
                              params=params_from_numpy(flat, ref.cfg, "cpu"))
    assert port.cfg.dtype == ref.cfg.dtype == "float32"
    fed.workloads.attach_engine("team-a", service, OnPrompts(port))
    prompts = np.random.default_rng(7).integers(0, ref.cfg.vocab_size, (2, 12))
    want = np.asarray(ref.generate(jnp.asarray(prompts, jnp.int32), 6)["tokens"])
    for _ in range(2):
        out = client.invoke(service, payload={"prompts": prompts.tolist(), "gen": 6})
        assert out["replica"] == "0" and out["service"] == service
        np.testing.assert_array_equal(np.asarray(out["output"]["tokens"]), want)


def test_real_stage_on_the_default_device_fails_without_a_card(monkeypatch):
    """A Federation on its default device (the card) where there is none:
    the stage's learner fails to build, the job ends FAILED with the
    learner's fatal log naming the missing card, and no step ran on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the path taken where no card is present")
    learners = []

    def spy(ctx):
        learners.append(texecutor.make_learner(ctx))
        return learners[-1]

    monkeypatch.setattr(tguardian, "make_learner", spy)
    fed = Federation(n_shards=2, n_hosts=2, chips_per_host=4, tick_period=5.0)
    assert fed.device is None and all(p.device is None for p in fed.shards)
    client = WorkloadClient.for_platform(fed, tenant="team-a")
    client.apply({**PIPELINE, "stages": PIPELINE["stages"][:1]})
    for _ in range(200):
        fed.tick()
        if client.get("lm")["status"]["phase"] not in ("PENDING", "RUNNING"):
            break
    st = client.get("lm")["status"]
    assert st["stages"]["train"]["state"] == "FAILED", st
    job = st["stages"]["train"]["job"]
    shard = fed.router.shard_for("team-a").platform
    assert shard.meta.get(job).status == JobStatus.FAILED
    logs = "\n".join(str(line) for line in ApiClient(fed.api, client.api_key).logs(job))
    assert "fatal: repro_torch runs on a CUDA card by default and none is available" in logs
    assert learners and all(isinstance(lr, texecutor.TorchLearner) and lr.step == 0
                            and not lr.loss_history for lr in learners)
    assert not shard.objstore.list("results")
