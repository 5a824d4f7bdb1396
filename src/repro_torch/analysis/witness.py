"""Runtime lock-order witness: acquisition-graph cycle detection (the
port's copy of ``src/repro/analysis/witness.py``). What changed:
:meth:`LockOrderWitness.install` defaults to the port's
``repro_torch.api.backend.RWLock``, and the module-level :data:`witness` is
the port's own, separate from the reference's.

The static LOCK-ORDER check sees lexical nesting; it cannot see a
cross-thread ABBA hazard assembled at runtime (thread 1 holds shard:0
and waits on shard:1 while thread 2 does the reverse — each acquisition
is lexically innocent). The witness closes that gap dynamically:

* :meth:`LockOrderWitness.install` monkeypatches
  ``RWLock.read_locked``/``write_locked`` (every shard lock in the
  platform, including each one ``AllShardsLock`` takes through its
  ``ExitStack``) to record, per thread, an edge ``held -> attempting``
  at acquisition-**attempt** time — before blocking, so an acquisition
  that later fails with ``DeadlineExceeded`` still contributes its
  hazard edge — and to push onto the thread's held-stack only after
  the acquisition *succeeds* (a failed wait must not corrupt the
  stack).
* After a workload runs (a test module, a chaos benchmark), the
  accumulated directed graph over lock names (``shard:0``, ``shard:1``,
  ...) must be **acyclic**: a cycle is a witnessed deadlock hazard even
  if the schedule that would actually deadlock never fired.

The port's tests install the module-level :data:`witness` for each
parity module that mirrors one of the reference's witnessed modules
(``tests/_torch_mirror.py``'s ``port_witness``) and assert acyclicity at
its end; ``chip_smoke.py`` installs it over the card's platform phases.
Unit tests exercise private instances so a seeded cycle never leaks into
the global graph.
"""

from __future__ import annotations

import contextlib
import threading


class LockOrderWitness:
    """Records the cross-thread lock-acquisition graph; see module doc."""

    def __init__(self):
        self._tls = threading.local()
        self._mu = threading.Lock()
        self.edges = {}          # name -> set of names acquired while held
        self.acquisitions = 0    # total successful acquisitions observed
        self._installed = None   # (cls, orig_read, orig_write) when active

    # -- recording ---------------------------------------------------------

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def record_attempt(self, name: str) -> None:
        """Edge from the innermost held lock to ``name`` (attempt time)."""
        st = self._stack()
        if st and st[-1] != name:
            with self._mu:
                self.edges.setdefault(st[-1], set()).add(name)

    def push(self, name: str) -> None:
        self._stack().append(name)
        with self._mu:
            self.acquisitions += 1

    def pop(self, name: str) -> None:
        st = self._stack()
        # remove the innermost matching entry (reentrant read locks may
        # stack the same name twice)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    def reset(self) -> None:
        with self._mu:
            self.edges = {}
            self.acquisitions = 0

    # -- instrumentation ---------------------------------------------------

    @staticmethod
    def _lock_name(lock) -> str:
        return getattr(lock, "name", None) or f"lock@{id(lock):x}"

    def install(self, lock_cls=None) -> None:
        """Wrap ``RWLock.read_locked``/``write_locked`` on ``lock_cls``
        (default: the platform's ``repro_torch.api.backend.RWLock``)."""
        if self._installed is not None:
            return
        if lock_cls is None:
            from repro_torch.api.backend import RWLock as lock_cls
        orig_read = lock_cls.read_locked
        orig_write = lock_cls.write_locked
        witness = self

        def _wrap(orig):
            @contextlib.contextmanager
            def wrapped(lock, *args, **kwargs):
                name = witness._lock_name(lock)
                witness.record_attempt(name)
                with orig(lock, *args, **kwargs):
                    witness.push(name)
                    try:
                        yield
                    finally:
                        witness.pop(name)
            return wrapped

        lock_cls.read_locked = _wrap(orig_read)
        lock_cls.write_locked = _wrap(orig_write)
        self._installed = (lock_cls, orig_read, orig_write)

    def uninstall(self) -> None:
        if self._installed is None:
            return
        lock_cls, orig_read, orig_write = self._installed
        lock_cls.read_locked = orig_read
        lock_cls.write_locked = orig_write
        self._installed = None

    # -- analysis ----------------------------------------------------------

    def snapshot(self):
        with self._mu:
            return {k: set(v) for k, v in self.edges.items()}

    def find_cycle(self):
        """A list of lock names forming a cycle, or None if acyclic."""
        graph = self.snapshot()
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {}
        parent = {}

        def dfs(start):
            stack = [(start, iter(sorted(graph.get(start, ()))))]
            color[start] = GRAY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    c = color.get(nxt, WHITE)
                    if c == GRAY:
                        # unwind the gray chain into an explicit cycle
                        cycle = [nxt, node]
                        cur = node
                        while cur != nxt:
                            cur = parent[cur]
                            cycle.append(cur)
                        cycle.reverse()
                        return cycle
                    if c == WHITE:
                        color[nxt] = GRAY
                        parent[nxt] = node
                        stack.append((nxt, iter(sorted(graph.get(nxt, ())))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
            return None

        for start in sorted(graph):
            if color.get(start, WHITE) == WHITE:
                cycle = dfs(start)
                if cycle:
                    return cycle
        return None

    def assert_acyclic(self, context: str = "") -> None:
        cycle = self.find_cycle()
        if cycle:
            where = f" after {context}" if context else ""
            raise AssertionError(
                f"lock-order witness found an acquisition cycle{where}: "
                + " -> ".join(cycle)
                + f" (graph: { {k: sorted(v) for k, v in sorted(self.snapshot().items())} })"
            )


#: The port's process-wide witness; the port's tests and chip_smoke.py
#: install it where they check the port's lock order.
witness = LockOrderWitness()
