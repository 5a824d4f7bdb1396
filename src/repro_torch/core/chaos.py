"""Chaos engineering hooks (FfDL §6 cites Simian Army / failure-as-a-service;
§5.6 reports the real fault distribution).

``ChaosMonkey`` injects, deterministically (seeded), every failure class the
paper observed: learner process crashes, node NotReady, guardian crashes,
helper/controller crashes, etcd/metastore blips, object-store faults, and
volume-provisioning failures, at configurable rates. Benchmarks/failures.py
drives a long campaign and aggregates the event log into the paper's
Table 8 / Fig 7-8 analysis.

``ChaosConfig`` remains the compat shim for the probabilistic kill/fault
rates, but the *point-failure* paths (volume provisioning, object-store
faults) now ride the unified fault-injection registry
(:class:`repro_torch.core.faults.FaultPlane`): an admin-installed plan on
``volume.provision`` or ``objstore.*`` composes with the probability
draws below. The monkey's own RNG stream is untouched — draw order and
count are identical with or without a plane attached — so seeded
campaigns reproduce bit-for-bit (``benchmarks/failures.py`` output is
unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ChaosConfig:
    seed: int = 0
    # per-tick probabilities (simulation granularity)
    p_learner_crash: float = 0.0
    p_host_fail: float = 0.0
    p_guardian_crash: float = 0.0
    p_controller_crash: float = 0.0
    p_volume_fail: float = 0.0   # per provisioning attempt
    p_objstore_fail: float = 0.0
    host_recovery_s: float = 120.0  # NotReady hosts reboot after this


class ChaosMonkey:
    def __init__(self, cfg: ChaosConfig, platform):
        self.cfg = cfg
        self.p = platform
        self.rng = np.random.default_rng(cfg.seed)
        self.enabled = True
        self._downed_hosts: dict[str, float] = {}

    def should_fail(self, kind: str, _key: str) -> bool:
        """Point-failure queries (e.g. volume provisioning in the Guardian).

        The probability draw stays on the monkey's own RNG stream (same
        draw order/count as before the fault plane existed), then the
        shared registry gets a say: an installed ``volume.provision``
        plan can force the failure deterministically.
        """
        if not self.enabled:
            return False
        if kind == "volume_provision":
            hit = bool(self.rng.random() < self.cfg.p_volume_fail)
            plane = getattr(self.p, "faults", None)
            if not hit and plane is not None:
                hit = plane.should_fail("volume.provision", key=_key)
            return hit
        return False

    def tick(self):
        if not self.enabled:
            return
        cfg, rng, p = self.cfg, self.rng, self.p
        # learner crashes
        if cfg.p_learner_crash > 0:
            for g in list(p.guardians.values()):
                if g.stage != "MONITOR":
                    continue
                for k, pod in enumerate(g.pods):
                    if pod.phase.value == "Running" and \
                            rng.random() < cfg.p_learner_crash:
                        rt = g.runtimes.get(k)
                        if rt is not None:
                            rt.kill()
                        p.cluster.fail_pod(pod.name, reason="chaos")
                        p.events.emit("chaos", "learner_killed",
                                      job=g.job_id, learner=k)
        # host failures
        if cfg.p_host_fail > 0:
            for hid, host in p.cluster.hosts.items():
                if host.ready and hid not in self._downed_hosts and \
                        rng.random() < cfg.p_host_fail:
                    p.cluster.fail_host(hid)
                    self._downed_hosts[hid] = p.clock.now()
                    p.events.emit("chaos", "host_killed", host=hid)
        # host recoveries
        for hid, t0 in list(self._downed_hosts.items()):
            if p.clock.now() - t0 >= cfg.host_recovery_s:
                p.cluster.recover_host(hid)
                del self._downed_hosts[hid]
        # guardian crashes (K8s restarts them next tick)
        if cfg.p_guardian_crash > 0:
            for g in list(p.guardians.values()):
                if g.alive and g.stage != "GC_DONE" and \
                        rng.random() < cfg.p_guardian_crash:
                    g.crash()
                    p.clock.call_later(2.0, g.restart)
        # controller crashes
        if cfg.p_controller_crash > 0:
            for g in list(p.guardians.values()):
                if g.controller is not None and g.controller.alive and \
                        rng.random() < cfg.p_controller_crash:
                    g.controller.crash()
                    p.events.emit("chaos", "controller_killed", job=g.job_id)
                    p.clock.call_later(3.5, g.controller.restart)
        # object-store faults: the draw stays on the monkey's stream; the
        # injection itself rides the unified registry (one-shot plan on
        # the next objstore op) when a plane is attached, falling back to
        # the legacy fail_next counter otherwise
        if cfg.p_objstore_fail > 0 and rng.random() < cfg.p_objstore_fail:
            plane = getattr(p, "faults", None)
            if plane is not None:
                plane.install("objstore.*", key=p.objstore.fault_key,
                              error="chaos object-store fault",
                              mode="one_shot")
            else:
                p.objstore.fail_next = 1
