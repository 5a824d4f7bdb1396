"""Unified fault-injection plane + the gray-failure defense primitives.

FfDL's dependability study (Boag et al. 2018) catalogs the faults that
actually hurt a multi-tenant platform: not clean crashes (those the LB
and the shard liveness flag already mask) but *gray* failures — slow
disks, hung components, flaky object stores. This module provides both
halves of the resilience story:

* **Injection** — :class:`FaultPlane` is a seeded registry of named
  interposition points (:data:`FAULT_POINTS`) threaded through the
  stack (WAL append/flush, object-store get/put, shard tick, per-verb
  gateway dispatch, HTTP transport send/recv, volume provisioning).
  A :class:`FaultPlan` installed on a point deterministically injects
  added latency, one-shot/persistent errors, or a full hang; plans are
  runtime-controllable via the ``/v2/admin/faults`` routes and the
  same registry serves :class:`~repro_torch.core.chaos.ChaosMonkey`'s legacy
  point-failure queries.

* **Defenses** — a thread-local deadline context
  (:func:`deadline_scope` / :func:`remaining` / :func:`deadline_sleep`)
  that bounds every blocking wait on the request path (the gateway
  wraps each v1 verb in a scope; ``RWLock`` bounds its condition
  waits; injected hangs and sleeps observe the ambient deadline), and
  a per-shard circuit breaker (:class:`BreakerPolicy`, pure and
  property-testable like the operator policy, fronted by the
  thread-safe :class:`ShardBreaker`) that quarantines a wedged-but-
  alive shard the way a dead one is quarantined.

Core must stay importable without the API tier, so the deadline error
here is a plain exception (:class:`DeadlineExceeded`); the gateway
translates it to the wire-stable ``DEADLINE_EXCEEDED`` ApiError.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

# The pinned interposition-point registry. Sites pass one of these names
# (plans may also use a trailing-`*` wildcard, e.g. ``objstore.*``).
FAULT_POINTS = (
    "wal.append",         # MetaStore._append — every durable mutation
    "wal.flush",          # MetaStore._commit — group-commit flush
    "objstore.get",       # ObjectStore.get — checkpoint/dataset reads
    "objstore.put",       # ObjectStore.put — checkpoint/result writes
    "shard.tick",         # FfDLPlatform.tick — the shard's control loop
    "gateway.dispatch",   # ApiGateway per-verb dispatch (key = verb name)
    "http.send",          # HttpTransport request send
    "http.recv",          # HttpTransport response read
    "volume.provision",   # guardian volume staging (ChaosMonkey compat)
)

FAULT_MODES = ("persistent", "one_shot")

# Safety valve: an injected hang whose plan is never cleared releases
# after this long so an un-cleared plan cannot wedge a test run forever.
MAX_HANG_S = 30.0


class DeadlineExceeded(Exception):
    """A blocking wait outlived the ambient deadline budget."""


class FaultInjected(RuntimeError):
    """Default error raised by an error-mode plan when the interposition
    site does not supply its own exception factory."""


# -- thread-local deadline context ---------------------------------------

_TLS = threading.local()


class _DeadlineScope:
    """Context manager installing a deadline ``budget_s`` from now on the
    current thread. Nested scopes never *extend* the outer deadline."""

    def __init__(self, budget_s: float):
        self._budget_s = budget_s
        self._prev: Optional[float] = None

    def __enter__(self):
        deadline = time.monotonic() + self._budget_s
        self._prev = getattr(_TLS, "deadline", None)
        if self._prev is not None:
            deadline = min(self._prev, deadline)
        _TLS.deadline = deadline
        return self

    def __exit__(self, *exc):
        _TLS.deadline = self._prev
        return False


def deadline_scope(budget_s: float) -> _DeadlineScope:
    """Bound every deadline-aware wait on this thread to ``budget_s``."""
    return _DeadlineScope(budget_s)


def remaining() -> Optional[float]:
    """Seconds left in the ambient deadline, or ``None`` outside any
    scope. May be negative once the budget is exhausted."""
    deadline = getattr(_TLS, "deadline", None)
    return None if deadline is None else deadline - time.monotonic()


def check_deadline(what: str = "operation"):
    """Raise :class:`DeadlineExceeded` if the ambient budget is spent."""
    rem = remaining()
    if rem is not None and rem <= 0:
        raise DeadlineExceeded(f"{what} exceeded its deadline budget")


def deadline_sleep(seconds: float, what: str = "sleep"):
    """Sleep ``seconds``, but never past the ambient deadline: if the
    budget runs out first, sleep what is left and raise."""
    rem = remaining()
    if rem is None:
        time.sleep(seconds)
        return
    if rem <= 0:
        raise DeadlineExceeded(f"{what} exceeded its deadline budget")
    if seconds >= rem:
        time.sleep(rem)
        raise DeadlineExceeded(f"{what} exceeded its deadline budget")
    time.sleep(seconds)


# -- fault plans + the plane ---------------------------------------------

@dataclass
class FaultPlan:
    """One installed fault: where it bites, whom, and how."""

    point: str                       # FAULT_POINTS name or "prefix.*"
    key: Optional[str] = None        # exact site-key match (None = any)
    latency_s: float = 0.0           # added delay before the op
    error: Optional[str] = None      # raise with this message
    hang: bool = False               # block until cleared / deadline
    mode: str = "persistent"         # or "one_shot"
    probability: float = 1.0         # seeded draw per matching call
    fault_id: str = ""
    hits: int = 0
    spent: bool = False              # one_shot already consumed
    cleared: threading.Event = field(default_factory=threading.Event,
                                     repr=False, compare=False)

    def matches(self, point: str, key: Optional[str]) -> bool:
        if self.spent:
            return False
        if self.point.endswith(".*"):
            if not point.startswith(self.point[:-1]):
                return False
        elif self.point != point:
            return False
        return self.key is None or self.key == key

    def view(self) -> dict:
        return {"fault_id": self.fault_id, "point": self.point,
                "key": self.key, "latency_s": self.latency_s,
                "error": self.error, "hang": self.hang, "mode": self.mode,
                "probability": self.probability, "hits": self.hits,
                "spent": self.spent}


def _validate_point(point) -> str:
    if not isinstance(point, str) or not point:
        raise ValueError(f"point must be a non-empty string, got {point!r}")
    if point in FAULT_POINTS:
        return point
    if point.endswith(".*") and any(p.startswith(point[:-1])
                                    for p in FAULT_POINTS):
        return point
    raise ValueError(f"unknown fault point {point!r}; "
                     f"known points: {', '.join(FAULT_POINTS)}")


class FaultPlane:
    """Seeded registry of live :class:`FaultPlan` s, one per federation
    (shared by every shard) or per standalone platform.

    ``on(point, key)`` is the interposition hook sites call on the hot
    path: with no matching plan it is one dict lookup under a lock.
    All probability draws come from one seeded RNG stream so a campaign
    is reproducible end to end.
    """

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._plans: Dict[str, FaultPlan] = {}
        self._ctr = itertools.count(1)
        self._lock = threading.Lock()
        self.triggered: Dict[str, int] = {}   # point -> trigger count

    # -- registry management (the /v2/admin/faults verbs land here) ------
    def install(self, point: str, *, key: Optional[str] = None,
                latency_s: float = 0.0, error: Optional[str] = None,
                hang: bool = False, mode: str = "persistent",
                probability: float = 1.0) -> dict:
        point = _validate_point(point)
        if mode not in FAULT_MODES:
            raise ValueError(f"mode must be one of {FAULT_MODES}, "
                             f"got {mode!r}")
        if not (isinstance(latency_s, (int, float)) and latency_s >= 0):
            raise ValueError(f"latency_s must be >= 0, got {latency_s!r}")
        if not (isinstance(probability, (int, float))
                and 0.0 < probability <= 1.0):
            raise ValueError(f"probability must be in (0, 1], "
                             f"got {probability!r}")
        if error is not None and not isinstance(error, str):
            raise ValueError(f"error must be a message string, got {error!r}")
        if latency_s == 0 and error is None and not hang:
            raise ValueError("plan has no effect: set latency_s, error, "
                             "or hang")
        plan = FaultPlan(point=point, key=key, latency_s=float(latency_s),
                         error=error, hang=bool(hang), mode=mode,
                         probability=float(probability))
        with self._lock:
            plan.fault_id = f"fault-{next(self._ctr)}"
            self._plans[plan.fault_id] = plan
        return plan.view()

    def list(self) -> List[dict]:
        with self._lock:
            return [self._plans[fid].view() for fid in sorted(
                self._plans, key=lambda f: int(f.split("-")[1]))]

    def clear(self, fault_id: Optional[str] = None) -> int:
        """Remove one plan (or all); hung waiters are released."""
        with self._lock:
            ids = ([fault_id] if fault_id is not None
                   else list(self._plans))
            removed = 0
            for fid in ids:
                plan = self._plans.pop(fid, None)
                if plan is not None:
                    plan.cleared.set()
                    removed += 1
        return removed

    # -- the interposition hook ------------------------------------------
    def _match(self, point: str, key: Optional[str]) -> Optional[FaultPlan]:
        with self._lock:
            if not self._plans:
                return None
            for fid in sorted(self._plans,
                              key=lambda f: int(f.split("-")[1])):
                plan = self._plans[fid]
                if not plan.matches(point, key):
                    continue
                if plan.probability < 1.0 and \
                        self.rng.random() >= plan.probability:
                    continue
                plan.hits += 1
                self.triggered[point] = self.triggered.get(point, 0) + 1
                if plan.mode == "one_shot":
                    if plan.hang:
                        plan.spent = True   # keep it; clear() must wake us
                    else:
                        del self._plans[fid]
                return plan
        return None

    def on(self, point: str, key: Optional[str] = None,
           exc: Optional[Callable[[str], BaseException]] = None):
        """Interposition hook. No matching plan: near-free. Otherwise
        apply the plan's latency / hang / error, observing the ambient
        deadline (latency and hangs raise :class:`DeadlineExceeded`
        when they outlive the caller's budget)."""
        plan = self._match(point, key)
        if plan is None:
            return
        what = f"injected fault at {point}"
        if plan.latency_s > 0:
            deadline_sleep(plan.latency_s, what=what)
        if plan.hang:
            self._hang(plan, what)
        if plan.error is not None:
            raise (exc or FaultInjected)(plan.error)

    def should_fail(self, point: str, key: Optional[str] = None) -> bool:
        """Boolean query form of :meth:`on` for legacy ChaosMonkey-style
        call sites that raise their own failures. Consumes one-shots."""
        return self._match(point, key) is not None

    def _hang(self, plan: FaultPlan, what: str):
        """Block until the plan is cleared, the ambient deadline expires
        (raises), or the :data:`MAX_HANG_S` safety valve releases."""
        release_at = time.monotonic() + MAX_HANG_S
        while True:
            rem = remaining()
            if rem is not None and rem <= 0:
                raise DeadlineExceeded(f"{what} exceeded its deadline "
                                       f"budget (hang)")
            cap = release_at - time.monotonic()
            if cap <= 0:
                return
            wait = cap if rem is None else min(rem, cap)
            if plan.cleared.wait(wait):
                return


# -- circuit breaker ------------------------------------------------------

BREAKER_STATES = ("closed", "half_open", "open")
# numeric encoding used by the ffdl_breaker_state metric family
BREAKER_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


@dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3    # consecutive failures that open it
    cooldown_s: float = 5.0       # open -> half_open after this long
    probe_successes: int = 1      # half_open successes that close it


class BreakerPolicy:
    """Pure closed → open → half-open circuit-breaker state machine.

    Like :class:`~repro.obs.operator.OperatorPolicy`, the transition
    function is deliberately free of I/O and wall clocks: callers feed
    it explicit ``now`` timestamps and *aggregate* outcome counts via
    :meth:`step` / :meth:`observe`. Within one step the aggregation
    rule is order-independent by construction — successes reset the
    failure streak first, then failures extend it — so replaying a
    shuffled observation batch yields the identical transition journal
    (property-tested in ``tests/test_faults.py``).
    """

    def __init__(self, config: Optional[BreakerConfig] = None):
        self.cfg = config or BreakerConfig()
        self.state = "closed"
        self.failure_streak = 0
        self.opened_at: Optional[float] = None
        self.probe_successes = 0
        self.transitions: List[dict] = []   # journal of state changes

    def _to(self, now: float, state: str, reason: str):
        self.transitions.append({"at": now, "from": self.state,
                                 "to": state, "reason": reason})
        self.state = state
        if state == "open":
            self.opened_at = now
            self.probe_successes = 0
        elif state == "half_open":
            self.probe_successes = 0
        elif state == "closed":
            self.failure_streak = 0
            self.opened_at = None

    def _maybe_half_open(self, now: float):
        if self.state == "open" and \
                now - self.opened_at >= self.cfg.cooldown_s:
            self._to(now, "half_open", "cooldown elapsed")

    def step(self, now: float, successes: int = 0, failures: int = 0):
        """Consume aggregate outcome counts observed since last step."""
        self._maybe_half_open(now)
        if self.state == "closed":
            if successes > 0:
                self.failure_streak = 0
            if failures > 0:
                self.failure_streak += failures
                if self.failure_streak >= self.cfg.failure_threshold:
                    self._to(now, "open",
                             f"{self.failure_streak} consecutive failures")
        elif self.state == "half_open":
            if failures > 0:
                self._to(now, "open", "probe failed")
            elif successes > 0:
                self.probe_successes += successes
                if self.probe_successes >= self.cfg.probe_successes:
                    self._to(now, "closed", "probe succeeded")
        # open: outcomes of straggler in-flight requests are ignored

    def observe(self, now: float, outcomes) -> str:
        """Batch form: ``outcomes`` is any iterable of ``"ok"``/``"fail"``
        strings. Aggregated before stepping, so the result is invariant
        under reordering of the batch. Returns the post-step state."""
        outcomes = list(outcomes)
        self.step(now, successes=sum(1 for o in outcomes if o == "ok"),
                  failures=sum(1 for o in outcomes if o != "ok"))
        return self.state

    def allow_request(self, now: float) -> bool:
        """Admission check: closed and half-open admit (half-open traffic
        is the probe); open fast-fails until the cooldown elapses."""
        self._maybe_half_open(now)
        return self.state != "open"


class ShardBreaker:
    """Thread-safe live front for :class:`BreakerPolicy`, one per
    :class:`~repro_torch.api.backend.Backend`. The gateway records one
    outcome per v1 verb; ``Federation.tick`` records tick deadline
    overruns; ``allow()`` gates shard selection."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._policy = BreakerPolicy(config)
        self._clock = clock
        self._lock = threading.Lock()
        self.deadline_exceeded_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            # surface time-driven open -> half_open without an outcome
            self._policy._maybe_half_open(self._clock())
            return self._policy.state

    @property
    def transitions(self) -> List[dict]:
        with self._lock:
            return list(self._policy.transitions)

    def record_success(self):
        with self._lock:
            self._policy.step(self._clock(), successes=1)

    def record_failure(self, deadline: bool = False):
        with self._lock:
            if deadline:
                self.deadline_exceeded_total += 1
            self._policy.step(self._clock(), failures=1)

    def allow(self) -> bool:
        with self._lock:
            return self._policy.allow_request(self._clock())

    def reset(self):
        """Fresh closed state (used on shard restart: a restart clears
        the gray-failure presumption; if the shard is still wedged the
        breaker re-opens within ``failure_threshold`` requests)."""
        with self._lock:
            self._policy = BreakerPolicy(self._policy.cfg)
