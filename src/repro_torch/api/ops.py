"""Operator wiring: attach the autonomous reconciler to a federation.

The port's copy of the reference's ``repro/api/ops.py``, its code unchanged.

``install_operator`` is the single composition point between the
observability plane's :class:`~repro_torch.obs.operator.Operator` and the
serving stack: it hangs the operator off the federation (so
``Federation.tick`` runs one reconcile pass per round, after the shard
ticks and migration ``advance()``) and off the admin plane (so
``GET /v2/admin/operator`` and ``POST /v2/admin/operator/rollout`` reach
it through the ordinary admin gateway / transport / CLI chain).

Deployments that never call this keep the human-driven behaviour: a
human drives the v2 verbs, and the operator routes answer NOT_FOUND.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.operator import Operator, OperatorConfig


def install_operator(federation,
                     config: Optional[OperatorConfig] = None) -> Operator:
    """Create an :class:`Operator` for ``federation`` and wire it into the
    tick loop and the admin plane. Idempotent-ish: installing again
    replaces the previous operator (fresh policy state)."""
    op = Operator(federation, config=config)
    federation.operator = op
    federation.admin.operator = op
    return op


def uninstall_operator(federation):
    """Detach the operator: the fleet goes back to human-driven."""
    federation.operator = None
    federation.admin.operator = None
