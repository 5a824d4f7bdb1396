"""Biased Sampling Algorithm (BSA) for gang placement (FfDL §3.5).

The paper (citing Tantawi [43, 44]): the gang placement problem is an
assignment of logical entities (pods) to physical entities (nodes) under
resource constraints with an objective (pack GPUs); the solution space is
combinatorially explosive, so BSA *importance-samples* candidate nodes with
a bias toward nodes that both satisfy the constraints and optimize the
objective, then keeps the best sampled assignment.

Our TPU adaptation keeps the algorithm shape — filter → bias → sample →
score → best-of-restarts — and adds an ICI-locality term to the objective:
a gang packed onto torus-adjacent hosts forms a contiguous mesh slice,
which is the TPU analogue of FfDL's communication-cost motivation for PACK.

The port's copy of the reference's (``repro/core/bsa.py``): the same
topology, sampling and scoring over the reference's simulated cluster
(``cluster.py``), so that placements equal the reference's draw for draw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.cluster import Host, torus_distance


@dataclass
class Placement:
    host_ids: list  # host id per pod (len == n_pods)
    score: float


def _bias_weights(hosts: Sequence[Host], free: np.ndarray, demand: int,
                  policy: str, chosen_coords: list, torus: tuple) -> np.ndarray:
    """Sampling bias per host for the next pod of the gang."""
    fits = (free >= demand).astype(np.float64)
    if policy == "pack":
        # Prefer hosts already partially used (small free), and hosts close
        # to already-placed gang members on the torus.
        used_frac = 1.0 - free / np.maximum(
            np.array([h.n_chips for h in hosts], dtype=np.float64), 1)
        w = fits * (0.25 + used_frac)
        if chosen_coords:
            d = np.array([
                min(torus_distance(h.coord, c, torus) for c in chosen_coords)
                for h in hosts], dtype=np.float64)
            w = w * (1.0 / (1.0 + d))
    elif policy == "spread":
        w = fits * (free + 1e-9)
        if chosen_coords:
            # spread avoids reusing hosts the gang already occupies
            occupied = {c for c in chosen_coords}
            for i, h in enumerate(hosts):
                if h.coord in occupied:
                    w[i] *= 0.05
    else:
        raise ValueError(policy)
    return w


def _score(hosts: Sequence[Host], free_after: np.ndarray,
           assignment: list, policy: str, torus: tuple) -> float:
    """Objective for a complete assignment (higher is better)."""
    used_idx = sorted(set(assignment))
    if policy == "pack":
        # (a) few distinct hosts; (b) little leftover fragmentation on the
        # touched hosts; (c) tight on the torus.
        n_hosts = len(used_idx)
        frag = float(sum(free_after[i] for i in used_idx))
        coords = [hosts[i].coord for i in used_idx]
        span = 0.0
        if len(coords) > 1:
            span = sum(torus_distance(a, b, torus)
                       for a in coords for b in coords) / (len(coords) ** 2)
        return -(3.0 * n_hosts + frag + span)
    # spread: many distinct hosts, balanced load
    return float(len(used_idx)) - float(np.std(free_after))


def bsa_place(hosts: Sequence[Host], n_pods: int, chips_per_pod: int,
              policy: str = "pack", torus: tuple = (1, 1),
              samples: int = 8, rng: Optional[np.random.Generator] = None,
              ) -> Optional[list]:
    """Place a gang of ``n_pods`` x ``chips_per_pod`` onto ``hosts``.

    Returns host_id per pod, or None if no feasible assignment was found.
    Deterministic for a given rng state.
    """
    if not hosts:
        return None
    rng = rng or np.random.default_rng(0)
    base_free = np.array([h.free_chips for h in hosts], dtype=np.int64)
    if int((base_free // max(chips_per_pod, 1)).sum()) < n_pods:
        return None  # quick infeasibility check

    best: Optional[Placement] = None
    for _ in range(max(samples, 1)):
        free = base_free.copy()
        assignment: list = []
        coords: list = []
        ok = True
        for _pod in range(n_pods):
            w = _bias_weights(hosts, free, chips_per_pod, policy, coords,
                              torus)
            total = w.sum()
            if total <= 0:
                ok = False
                break
            idx = int(rng.choice(len(hosts), p=w / total))
            assignment.append(idx)
            coords.append(hosts[idx].coord)
            free[idx] -= chips_per_pod
        if not ok:
            continue
        s = _score(hosts, free, assignment, policy, torus)
        if best is None or s > best.score:
            best = Placement([hosts[i].host_id for i in assignment], s)
    # Greedy fallback: first-fit-decreasing by the bias, in case sampling
    # repeatedly dead-ends on a feasible instance.
    if best is None:
        free = base_free.copy()
        assignment = []
        order = np.argsort(-free) if policy == "spread" else np.argsort(free)
        for _pod in range(n_pods):
            placed = False
            for i in order:
                if free[i] >= chips_per_pod and hosts[i].schedulable:
                    free[i] -= chips_per_pod
                    assignment.append(hosts[i].host_id)
                    placed = True
                    break
            if not placed:
                return None
        return assignment
    return best.host_ids
