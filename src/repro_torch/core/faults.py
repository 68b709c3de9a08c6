"""Failure and perturbation models (paper Table 1, "Execution scenarios").

Scenarios on miniHPC (16 nodes x 16 ranks = 256 PEs):

  Failures:       1, P/2, P-1 fail-stop failures, at arbitrary times during
                  execution; failed cores do not recover.  The master (PE 0)
                  never fails (paper limitation: master is a SPOF).
  Perturbations:  PE availability   — all PEs of one node slowed (CPU burner),
                  Network latency   — +10 s per message to/from one node,
                  Combined          — both at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PEProfile:
    """Static per-PE behaviour for one experiment."""
    speed: float = 1.0                 # relative compute speed (1.0 nominal)
    fail_time: Optional[float] = None  # fail-stop instant (None = survives)
    msg_latency: float = 0.0           # extra seconds per message to/from PE


@dataclasses.dataclass
class Scenario:
    name: str
    profiles: list[PEProfile]

    @property
    def P(self) -> int:
        return len(self.profiles)


def baseline(P: int) -> Scenario:
    return Scenario("baseline", [PEProfile() for _ in range(P)])


def failures(P: int, n_failures: int, *, t_exec_estimate: float,
             seed: int = 0) -> Scenario:
    """``n_failures`` distinct non-master PEs die at arbitrary times.

    Fail times are drawn uniformly over (0, t_exec_estimate) — "occur
    arbitrary during execution".  PE 0 (master) never fails.
    """
    if not 0 <= n_failures <= P - 1:
        raise ValueError(f"need 0 <= n_failures <= P-1, got {n_failures}")
    rng = np.random.default_rng(seed)
    victims = rng.choice(np.arange(1, P), size=n_failures, replace=False)
    times = rng.uniform(0.05 * t_exec_estimate, 0.95 * t_exec_estimate,
                        size=n_failures)
    profiles = [PEProfile() for _ in range(P)]
    for v, t in zip(victims, times):
        profiles[int(v)].fail_time = float(t)
    return Scenario(f"fail_{n_failures}", profiles)


def pe_perturbation(P: int, *, node_size: int = 16, node: int = 1,
                    slowdown: float = 0.25) -> Scenario:
    """All PEs on one node compute at ``slowdown`` x nominal (CPU burner)."""
    profiles = [PEProfile() for _ in range(P)]
    for pe in range(node * node_size, min(P, (node + 1) * node_size)):
        profiles[pe].speed = slowdown
    return Scenario("pe_perturb", profiles)


def latency_perturbation(P: int, *, node_size: int = 16, node: int = 1,
                         delay: float = 10.0) -> Scenario:
    """+``delay`` seconds per message to/from every PE of one node."""
    profiles = [PEProfile() for _ in range(P)]
    for pe in range(node * node_size, min(P, (node + 1) * node_size)):
        profiles[pe].msg_latency = delay
    return Scenario("latency_perturb", profiles)


def combined_perturbation(P: int, *, node_size: int = 16, node: int = 1,
                          slowdown: float = 0.25,
                          delay: float = 10.0) -> Scenario:
    profiles = [PEProfile() for _ in range(P)]
    for pe in range(node * node_size, min(P, (node + 1) * node_size)):
        profiles[pe].speed = slowdown
        profiles[pe].msg_latency = delay
    return Scenario("combined_perturb", profiles)


def paper_scenarios(P: int, *, t_exec_estimate: float,
                    seed: int = 0) -> dict[str, Scenario]:
    """The seven execution scenarios of Table 1."""
    return {
        "baseline": baseline(P),
        "fail_1": failures(P, 1, t_exec_estimate=t_exec_estimate, seed=seed),
        "fail_half": failures(P, P // 2, t_exec_estimate=t_exec_estimate,
                              seed=seed + 1),
        "fail_pm1": failures(P, P - 1, t_exec_estimate=t_exec_estimate,
                             seed=seed + 2),
        "pe_perturb": pe_perturbation(P),
        "latency_perturb": latency_perturbation(P),
        "combined_perturb": combined_perturbation(P),
    }
