"""Closed-form performance model of rDLB (paper §3.1).

Setting: q PEs, n equal tasks per PE, each of duration t (so T = n·t without
failures), exponential fail-stop failures with rate λ, and rDLB re-executing
a failed PE's unfinished tasks spread over the q−1 survivors.

    E[T]  = T + (1 − e^{−λT}) · (t/2) · (n+1)/(q−1)
    E[T]  ≈ T + λT · (t/2) · (n+1)/(q−1)              (first order in λT)
    H_T   = E[T]/T − 1 = (λt/2) · (n+1)/(q−1)          (rDLB overhead)
    H_C   = sqrt(2λC)                                  (checkpoint/restart)
    rDLB beats checkpointing iff  C ≥ (λt²/8) · (n+1)²/(q−1)²

Scalability: for fixed total work N = n·q, n ∝ 1/q so H_T ∝ (N/q+1)/(q−1)
— the cost of robustness decreases ~quadratically with the system size
(paper abstract/§5).  The reference validates these forms against the
discrete-event simulator (``benchmarks/theory_table.py``,
``tests/test_theory.py``); this copy is held to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import math

import numpy as np


def t_no_failure(n: int, t: float) -> float:
    """T = n·t (equal tasks, equally distributed)."""
    return n * t


def expected_time_one_failure(n: int, t: float, q: int, lam: float) -> float:
    """E[T] = T + (1 − e^{−λT})·(t/2)·(n+1)/(q−1)."""
    if q < 2:
        raise ValueError("need q >= 2 survivors to redistribute work")
    T = t_no_failure(n, t)
    p_fail = 1.0 - math.exp(-lam * T)
    return T + p_fail * (t / 2.0) * (n + 1) / (q - 1)


def expected_time_first_order(n: int, t: float, q: int, lam: float) -> float:
    """First-order approximation E[T] ≈ T + λT·(t/2)·(n+1)/(q−1)."""
    T = t_no_failure(n, t)
    return T + lam * T * (t / 2.0) * (n + 1) / (q - 1)


def rdlb_overhead(n: int, t: float, q: int, lam: float) -> float:
    """H_T = (λt/2)·(n+1)/(q−1)  (fractional overhead, first order)."""
    return (lam * t / 2.0) * (n + 1) / (q - 1)


def checkpoint_overhead(lam: float, C: float) -> float:
    """H_C = sqrt(2λC) — Young/Daly first-order checkpointing overhead."""
    return math.sqrt(2.0 * lam * C)


def checkpoint_crossover(n: int, t: float, q: int, lam: float) -> float:
    """C* such that rDLB beats checkpoint/restart iff C ≥ C*.

    C* = (λt²/8)·(n+1)²/(q−1)²  (from H_T ≤ H_C, first order, C << 1/λ).
    """
    return (lam * t * t / 8.0) * ((n + 1) ** 2) / ((q - 1) ** 2)


def rdlb_beats_checkpointing(n: int, t: float, q: int, lam: float,
                             C: float) -> bool:
    return C >= checkpoint_crossover(n, t, q, lam)


def monte_carlo_one_failure(n: int, t: float, q: int, lam: float,
                            *, reps: int = 20000, seed: int = 0) -> float:
    """Monte-Carlo estimate of E[T] under ≤1 failure, for validating the
    closed form (paper's model: if the PE fails while holding task i
    uniformly, the remaining n−i tasks are spread over q−1 survivors).
    """
    rng = np.random.default_rng(seed)
    T = n * t
    fail_at = rng.exponential(1.0 / lam, size=reps)     # failure instant
    fails = fail_at < T
    # task index in progress at failure, uniform over 0..n-1:
    i = rng.integers(0, n, size=reps)
    extra = np.where(fails, (n - i) / (q - 1) * t, 0.0)
    return float(np.mean(T + extra))
