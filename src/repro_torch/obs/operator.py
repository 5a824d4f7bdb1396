"""Autonomous operator loop (ROADMAP: the reconciler that drives the v2 plane).

The port's copy of the reference's ``repro/obs/operator.py``, its code unchanged.

FfDL's retrospective (§6) and Boag et al. 2018 both land on the same
conclusion: a multi-tenant platform's reaction to load and faults must be
automated.  The v2 plane built every primitive — per-shard occupancy, cordon /
drain, WAL-consistent migrations, the event bus, per-tenant metering — and
this module closes the loop with a watch → decide → act reconciler that
runs once per :meth:`Federation.tick`:

  * **shard autoscaling** — when fleet chip occupancy stays above
    ``high_water`` for ``streak_ticks`` consecutive ticks, spawn a fresh
    shard and drain the hottest tenant of the most-occupied shard into
    it; when occupancy stays below ``low_water``, drain the emptiest
    shard and retire it once its last resident has moved;
  * **hot-tenant isolation** — when one tenant accounts for more than
    ``hot_share`` of a shard's windowed heat (chip-seconds plus weighted
    429s), migrate it to the quietest shard;
  * **rolling shard upgrades** — GUARD-style progressive waves (drain →
    restart at the target version → uncordon, one shard per wave) with
    pre/post health validation; any shard death or post-restart failure
    regression halts the rollout and rolls the current wave back
    (uncordon + migrate the drained tenants home).

The split below is deliberate: :class:`OperatorPolicy` is a *pure* state
machine — ``decide(obs)`` maps an observation dict to a list of decision
dicts with no I/O, no clock and no RNG, and sorts every candidate list
internally so the decisions are a deterministic function of the observed
stats regardless of how the observation was enumerated (the property test
replays one trace under shuffled shard orders and asserts identical
logs).  :class:`Operator` wraps it with sensing (reads shard stats under
the plane mutex, exactly like ``shard_view``) and acting (the same
``/v2/admin`` verbs a human admin would call), journaling every action as
an ``operator_*`` platform event.
"""

from __future__ import annotations

import collections
import copy
import threading
from dataclasses import asdict, dataclass
from typing import Deque, Dict, List, Optional

# Decision/event vocabulary.  Every act the operator takes is journaled
# on the event bus under one of these kinds (docs/api.md pins them; they
# are part of PLATFORM_EVENT_KINDS in repro_torch.obs.bus).
OPERATOR_EVENT_KINDS = (
    "operator_scale_up",
    "operator_scale_down",
    "operator_isolate_tenant",
    "operator_rollout_wave",
    "operator_rollout_done",
    "operator_rollout_halted",
    "operator_rollback",
    "operator_gray_restart",
)

_NEVER = -(10 ** 9)


@dataclass(frozen=True)
class OperatorConfig:
    """Thresholds for the reconciler (docs/architecture.md documents each)."""

    high_water: float = 0.85        # fleet occupancy that triggers scale-up
    low_water: float = 0.20         # fleet occupancy that triggers scale-down
    streak_ticks: int = 3           # consecutive ticks past a mark to act
    cooldown_ticks: int = 20        # min ticks between scaling actions
    min_shards: int = 2             # never scale below this many active shards
    max_shards: int = 8             # never scale above this many open shards
    hot_share: float = 0.60         # tenant share of shard heat to isolate
    min_heat: float = 1.0           # ignore shards cooler than this
    heat_window: int = 8            # ticks of usage deltas summed into heat
    heat_429_weight: float = 1.0    # 429s count this many chip-seconds each
    isolate_cooldown_ticks: int = 50  # per-tenant gap between isolations
    validate_ticks: int = 3         # post-restart health-watch ticks per wave
    allowed_failures: int = 0       # job_failed regressions tolerated per wave
    gray_cooldown_ticks: int = 30   # min ticks between restarts of one shard
    max_decisions: int = 200        # decision-log ring size


class OperatorPolicy:
    """Pure decision core: ``decide(obs)`` -> list of decision dicts.

    Holds only counters and the rollout state machine; never touches the
    federation.  All candidate selections sort by (metric, id) so ties —
    and therefore whole decision logs — are deterministic.
    """

    def __init__(self, config: OperatorConfig):
        self.config = config
        self.tick = 0
        self.high_streak = 0
        self.low_streak = 0
        self.last_scale_tick = _NEVER
        self.retiring: Optional[str] = None   # shard draining toward retirement
        self.rollout: Optional[dict] = None
        self.last_occupancy = 0.0
        self._isolated_at: Dict[str, int] = {}
        self._gray_at: Dict[str, int] = {}
        self.decisions: Deque[dict] = collections.deque(
            maxlen=config.max_decisions)

    # -- rollout requests (called via the admin plane) ---------------------
    def rollout_live(self) -> bool:
        return (self.rollout is not None
                and self.rollout["state"] not in ("done", "halted"))

    def request_rollout(self, version: str):
        """Record a rollout request; waves start on the next decide()."""
        from repro_torch.api.types import ApiError, ErrorCode
        if self.rollout_live():
            raise ApiError(
                ErrorCode.CONFLICT,
                f"rollout to {self.rollout['version']!r} is already "
                f"{self.rollout['state']}", version=self.rollout["version"])
        self.rollout = {"version": version, "state": "starting",
                        "wave": 0, "shard": None, "pending": None,
                        "upgraded": [], "drained": [], "validate_left": 0,
                        "fail_base": 0, "error": ""}

    # -- the decision function ---------------------------------------------
    def _log(self, decision: dict) -> dict:
        decision = {"tick": self.tick, **decision}
        self.decisions.append(decision)
        return decision

    def decide(self, obs: dict) -> List[dict]:
        cfg = self.config
        self.tick = obs["tick"]
        out: List[dict] = []
        shards = sorted((dict(s) for s in obs["shards"]),
                        key=lambda s: s["shard_id"])
        for s in shards:
            # canonical resident order: float sums and max() tie-breaks
            # below must not depend on how the observation enumerated them
            s["tenants"] = sorted(s["tenants"])
        heat = obs["tenant_heat"]
        open_ = [s for s in shards if s["alive"] and not s["retired"]]
        active = [s for s in open_ if not s["cordoned"]]
        down = [s["shard_id"] for s in shards
                if not s["alive"] and not s["retired"]]
        live_migs = obs["live_migrations"]

        total = sum(s["chips_total"] for s in open_)
        used = sum(s["chips_used"] for s in open_)
        occ = (used / total) if total else 0.0
        self.last_occupancy = occ

        # 0. finish a pending retirement: the drain we started earlier has
        # moved the last resident off — fence the shard out of the fleet.
        if self.retiring is not None:
            s = next((x for x in shards if x["shard_id"] == self.retiring),
                     None)
            if s is None or s["retired"]:
                self.retiring = None
            elif s["alive"] and not s["tenants"] and not live_migs:
                out.append(self._log({
                    "action": "retire_shard", "shard": self.retiring,
                    "reason": "drain complete; no residents remain"}))
                self.retiring = None

        # 0b. gray-failure response: a shard that is ALIVE but whose
        # circuit breaker is open is wedged, not dead — liveness checks
        # miss it (that is what makes the failure gray). A restart clears
        # the wedge (WAL recovery; the breaker resets closed); if the
        # shard is still sick the breaker re-opens and, after the
        # cooldown, we try again rather than flap every tick.
        for s in shards:
            if (s["alive"] and not s["retired"]
                    and s.get("breaker", "closed") == "open"
                    and self.tick - self._gray_at.get(
                        s["shard_id"], _NEVER) >= cfg.gray_cooldown_ticks):
                out.append(self._log({
                    "action": "gray_restart", "shard": s["shard_id"],
                    "reason": (f"breaker open on alive shard "
                               f"{s['shard_id']}: gray failure — restart "
                               f"to clear the wedge")}))
                self._gray_at[s["shard_id"]] = self.tick

        # 1. a live rollout owns the fleet: no autoscaling or isolation
        # runs underneath it (scaling mid-wave would fight the drain).
        if self.rollout_live():
            out.extend(self._decide_rollout(shards, active, down, live_migs))
            return out

        # 2. autoscaling streaks (fleet-wide occupancy).
        self.high_streak = self.high_streak + 1 if occ >= cfg.high_water else 0
        self.low_streak = self.low_streak + 1 if occ <= cfg.low_water else 0
        cooled = self.tick - self.last_scale_tick >= cfg.cooldown_ticks
        if (self.high_streak >= cfg.streak_ticks and cooled and active
                and not live_migs and not down
                and len(open_) < cfg.max_shards):
            donor = max(active, key=lambda s: (
                (s["chips_used"] / s["chips_total"]) if s["chips_total"]
                else 0.0, s["shard_id"]))
            d = {"action": "scale_up", "to_shard": obs["next_shard_id"],
                 "occupancy": round(occ, 4),
                 "reason": (f"fleet occupancy {occ:.2f} >= "
                            f"{cfg.high_water} for {self.high_streak} "
                            f"ticks")}
            hot = max(donor["tenants"],
                      key=lambda t: (heat.get(t, 0.0), t), default=None)
            if hot is not None:
                d["migrate_tenant"] = hot
                d["from_shard"] = donor["shard_id"]
            out.append(self._log(d))
            self.last_scale_tick = self.tick
            self.high_streak = 0
        elif (self.low_streak >= cfg.streak_ticks and cooled
                and not live_migs and not down and self.retiring is None
                and len(active) > cfg.min_shards):
            victim = min(active, key=lambda s: (
                s["active_jobs"], s["jobs"], s["shard_id"]))
            out.append(self._log({
                "action": "scale_down", "shard": victim["shard_id"],
                "occupancy": round(occ, 4),
                "reason": (f"fleet occupancy {occ:.2f} <= {cfg.low_water} "
                           f"for {self.low_streak} ticks; "
                           f"{victim['shard_id']} is emptiest")}))
            self.retiring = victim["shard_id"]
            self.last_scale_tick = self.tick
            self.low_streak = 0

        # 3. hot-tenant isolation (at most one migration kicked per tick,
        # and never while other migrations are in flight).
        if not live_migs and not down and len(active) >= 2:
            for s in active:
                residents = s["tenants"]
                if len(residents) < 2:
                    continue
                shard_heat = sum(heat.get(t, 0.0) for t in residents)
                if shard_heat < cfg.min_heat:
                    continue
                top = max(residents, key=lambda t: (heat.get(t, 0.0), t))
                share = heat.get(top, 0.0) / shard_heat
                if share < cfg.hot_share:
                    continue
                if (self.tick - self._isolated_at.get(top, _NEVER)
                        < cfg.isolate_cooldown_ticks):
                    continue
                others = [x for x in active
                          if x["shard_id"] != s["shard_id"]]
                quiet = min(others, key=lambda x: (
                    sum(heat.get(t, 0.0) for t in x["tenants"]),
                    x["chips_used"], x["shard_id"]))
                out.append(self._log({
                    "action": "isolate_tenant", "tenant": top,
                    "from_shard": s["shard_id"],
                    "to_shard": quiet["shard_id"],
                    "share": round(share, 3),
                    "reason": (f"tenant {top!r} holds {share:.0%} of "
                               f"{s['shard_id']} heat; moving to quietest "
                               f"shard {quiet['shard_id']}")}))
                self._isolated_at[top] = self.tick
                break
        return out

    # -- rollout state machine ---------------------------------------------
    def _halt(self, out: List[dict], reason: str):
        r = self.rollout
        r["state"] = "halted"
        r["error"] = reason
        out.append(self._log({
            "action": "rollout_halt", "shard": r["shard"],
            "wave": r["wave"], "version": r["version"], "reason": reason}))

    def _rollback(self, out: List[dict]):
        r = self.rollout
        out.append(self._log({
            "action": "rollback", "shard": r["shard"],
            "tenants": [t for t, _ in r["drained"]],
            "version": r["version"],
            "reason": "uncordon the wave shard and migrate its drained "
                      "tenants home"}))

    def _next_wave(self, out: List[dict]):
        r = self.rollout
        r["shard"] = r["pending"].pop(0)
        r["wave"] += 1
        r["drained"] = []
        r["state"] = "draining"
        out.append(self._log({
            "action": "rollout_wave", "shard": r["shard"],
            "wave": r["wave"], "version": r["version"],
            "reason": (f"wave {r['wave']}: drain -> restart at "
                       f"{r['version']!r} -> uncordon -> validate")}))

    def _decide_rollout(self, shards, active, down, live_migs) -> List[dict]:
        cfg = self.config
        r = self.rollout
        out: List[dict] = []
        # Health gate shared by every state: ANY open shard down mid-rollout
        # halts the whole rollout — upgrading into a degraded fleet is how
        # rollouts cascade (the ROADMAP chaos ask pins exactly this).
        if down:
            self._halt(out, f"shard {down[0]} went down during wave "
                            f"{r['wave']}")
            if r["shard"] is not None and r["shard"] not in down:
                self._rollback(out)
            return out
        if r["state"] == "starting":
            if live_migs:
                return out  # pre-validation: let the fleet settle first
            r["pending"] = [s["shard_id"] for s in active
                            if s["version"] != r["version"]]
            if not r["pending"]:
                r["state"] = "done"
                out.append(self._log({
                    "action": "rollout_done", "version": r["version"],
                    "waves": 0,
                    "reason": "every shard already runs the target version"}))
                return out
            self._next_wave(out)
            return out
        s = next((x for x in shards if x["shard_id"] == r["shard"]), None)
        if s is None:
            self._halt(out, f"wave shard {r['shard']} vanished")
            return out
        if r["state"] == "draining":
            if not live_migs and s["active_jobs"] == 0 and not s["tenants"]:
                out.append(self._log({
                    "action": "rollout_restart", "shard": r["shard"],
                    "version": r["version"],
                    "reason": "drain complete; restart at target version "
                              "and uncordon"}))
                r["state"] = "validating"
                r["validate_left"] = cfg.validate_ticks
                r["fail_base"] = s["failed_total"]
            return out
        if r["state"] == "validating":
            regressions = s["failed_total"] - r["fail_base"]
            if regressions > cfg.allowed_failures:
                self._halt(out, f"post-restart regression on {r['shard']}: "
                                f"{regressions} job failure(s)")
                self._rollback(out)
                return out
            r["validate_left"] -= 1
            if r["validate_left"] > 0:
                return out
            r["upgraded"].append(r["shard"])
            r["shard"] = None
            r["drained"] = []
            if r["pending"]:
                self._next_wave(out)
            else:
                r["state"] = "done"
                out.append(self._log({
                    "action": "rollout_done", "version": r["version"],
                    "waves": r["wave"],
                    "reason": f"all {r['wave']} wave(s) validated healthy"}))
            return out
        return out


class Operator:
    """Sense → decide → act against a :class:`~repro_torch.api.federation.Federation`.

    ``step()`` runs on the tick thread under the admin-plane mutex (plane
    mutex → shard lock, the same ordering every admin verb uses), so its
    actions serialize with concurrent admin verbs and its observations are
    as consistent as ``shard_view``'s.
    """

    def __init__(self, federation, config: Optional[OperatorConfig] = None):
        self.fed = federation
        self.config = config or OperatorConfig()
        self.policy = OperatorPolicy(self.config)
        self._mutex = threading.RLock()
        self._ticks = 0
        self._usage_prev: Dict[str, List[float]] = {}
        self._heat_win: Dict[str, Deque[float]] = {}

    # -- wire surface -------------------------------------------------------
    def status_view(self) -> dict:
        from repro_torch.api.types import ADMIN_API_VERSION
        with self._mutex:
            p = self.policy
            return {"api_version": ADMIN_API_VERSION, "enabled": True,
                    "tick": p.tick,
                    "occupancy": round(p.last_occupancy, 4),
                    "retiring": p.retiring,
                    "config": asdict(self.config),
                    "rollout": copy.deepcopy(p.rollout),
                    "decisions": [dict(d) for d in p.decisions]}

    def request_rollout(self, version: str) -> dict:
        from repro_torch.api.types import ApiError, ErrorCode
        with self._mutex:
            if not isinstance(version, str) or not version:
                raise ApiError(ErrorCode.INVALID_ARGUMENT,
                               "version must be a non-empty string")
            self.policy.request_rollout(version)
        return self.status_view()

    # -- the loop -----------------------------------------------------------
    def step(self) -> List[dict]:
        """One reconcile pass; called from Federation.tick after advance()."""
        with self.fed.admin._mutex:
            with self._mutex:
                obs = self._sense()
                decisions = self.policy.decide(obs)
                for d in decisions:
                    self._act(d)
                return decisions

    # -- sensing ------------------------------------------------------------
    def _sense(self) -> dict:
        from repro_torch.api.admin import LIVE_PHASES
        from repro_torch.core.types import TERMINAL, JobStatus
        cfg = self.config
        fed = self.fed
        self._ticks += 1
        usage_tot: Dict[str, List[float]] = {}
        shards = []
        for b in fed.router.backends:
            entry = {"shard_id": b.shard_id, "alive": b.alive,
                     "cordoned": b.cordoned,
                     "breaker": (b.breaker.state
                                 if getattr(b, "breaker", None) is not None
                                 else "closed"),
                     "retired": getattr(b, "retired", False),
                     "version": getattr(b, "version", "v0"),
                     "chips_total": 0, "chips_used": 0, "jobs": 0,
                     "active_jobs": 0, "queue_depth": 0, "tenants": [],
                     "failed_total": 0}
            if b.alive:
                with b.read_locked():
                    p = b.platform
                    meta = p.meta
                    active = 0
                    for st, ids in meta._by_status.items():
                        if st not in TERMINAL and st != JobStatus.HALTED:
                            active += len(ids)
                    entry.update({
                        "chips_total": p.cluster.total_chips,
                        "chips_used": p.cluster.used_chips,
                        "jobs": len(meta._order),
                        "active_jobs": active,
                        "queue_depth": p.scheduler.queue_depth(),
                        "tenants": sorted(
                            t for t, ids in meta._by_tenant.items() if ids),
                        "failed_total": p.events.count("job_failed")})
                    for tenant, row in p.meter.snapshot().items():
                        agg = usage_tot.setdefault(tenant, [0.0, 0.0])
                        agg[0] += row.get("chip_seconds", 0.0)
                        agg[1] += row.get("throttled_429s", 0)
            shards.append(entry)
        # Windowed heat: per-step usage deltas summed over heat_window
        # ticks, so a tenant that WAS hot cools off instead of dominating
        # forever on cumulative counters.
        heat: Dict[str, float] = {}
        for tenant in sorted(set(usage_tot) | set(self._heat_win)):
            cur = usage_tot.get(tenant, [0.0, 0.0])
            prev = self._usage_prev.get(tenant, [0.0, 0.0])
            step = (max(0.0, cur[0] - prev[0])
                    + cfg.heat_429_weight * max(0.0, cur[1] - prev[1]))
            win = self._heat_win.setdefault(
                tenant, collections.deque(maxlen=cfg.heat_window))
            win.append(step)
            heat[tenant] = sum(win)
        self._usage_prev = {t: list(v) for t, v in usage_tot.items()}
        live = sum(1 for m in fed.admin.migrations.values()
                   if m.phase in LIVE_PHASES)
        return {"tick": self._ticks, "shards": shards,
                "live_migrations": live, "tenant_heat": heat,
                "next_shard_id": f"shard-{fed._next_shard_idx}"}

    # -- acting -------------------------------------------------------------
    def _emit(self, kind: str, **fields):
        """Journal an operator event into the first alive, unretired
        shard's bus (deterministic pick; best-effort like _emit_phase)."""
        for b in sorted(self.fed.router.backends, key=lambda b: b.shard_id):
            if b.alive and not getattr(b, "retired", False):
                try:
                    b.platform.events.emit("operator", kind, **fields)
                except Exception:
                    pass
                return

    def _act(self, d: dict):
        from repro_torch.api.types import ApiError
        try:
            self._dispatch(d)
        except ApiError as exc:
            # An admin verb refused the action (e.g. the migration target
            # got cordoned between sense and act). Journal it and, for a
            # rollout wave, halt: a wave whose drain failed must not sit
            # in "draining" forever.
            self.policy._log({"action": "act_failed", "attempted": d["action"],
                              "error": str(exc),
                              "reason": "admin verb rejected the action"})
            if d["action"] == "rollout_wave" and self.policy.rollout:
                self.policy.rollout["state"] = "halted"
                self.policy.rollout["error"] = f"wave drain failed: {exc}"
                self._emit("operator_rollout_halted",
                           shard=d.get("shard"), wave=d.get("wave"),
                           version=d.get("version"),
                           reason=self.policy.rollout["error"])

    def _dispatch(self, d: dict):
        fed = self.fed
        admin = fed.admin
        action = d["action"]
        if action == "scale_up":
            sid = fed.add_shard()
            self._emit("operator_scale_up", shard=sid,
                       occupancy=d["occupancy"], reason=d["reason"])
            if "migrate_tenant" in d:
                admin.start_migration(d["migrate_tenant"], sid)
        elif action == "scale_down":
            admin.drain(d["shard"])
            self._emit("operator_scale_down", shard=d["shard"],
                       occupancy=d["occupancy"], reason=d["reason"])
        elif action == "retire_shard":
            fed.retire_shard(d["shard"])
        elif action == "isolate_tenant":
            admin.start_migration(d["tenant"], d["to_shard"])
            self._emit("operator_isolate_tenant", tenant=d["tenant"],
                       from_shard=d["from_shard"], to_shard=d["to_shard"],
                       share=d["share"], reason=d["reason"])
        elif action == "rollout_wave":
            self._emit("operator_rollout_wave", shard=d["shard"],
                       wave=d["wave"], version=d["version"])
            result = admin.drain(d["shard"])
            drained = [(admin.migrations[mid].tenant, d["shard"])
                       for mid in result["migrations"]]
            self.policy.rollout["drained"] = drained
        elif action == "gray_restart":
            b = fed.router.backend(d["shard"])
            version = getattr(b, "version", "v0")
            b.crash()
            b.restart(version=version)
            self._emit("operator_gray_restart", shard=d["shard"],
                       reason=d["reason"])
        elif action == "rollout_restart":
            b = fed.router.backend(d["shard"])
            b.crash()
            b.restart(version=d["version"])
            b.uncordon()
        elif action == "rollout_done":
            self._emit("operator_rollout_done", version=d["version"],
                       waves=d["waves"])
        elif action == "rollout_halt":
            self._emit("operator_rollout_halted", shard=d.get("shard"),
                       wave=d["wave"], version=d["version"],
                       reason=d["reason"])
        elif action == "rollback":
            try:
                b = fed.router.backend(d["shard"])
                if b.alive and b.cordoned:
                    b.uncordon()
            except KeyError:
                pass
            from repro_torch.api.types import ApiError
            for tenant in d["tenants"]:
                try:
                    admin.start_migration(tenant, d["shard"])
                except ApiError:
                    pass  # tenant's current shard may be down; best effort
            self._emit("operator_rollback", shard=d["shard"],
                       tenants=d["tenants"], version=d["version"])
