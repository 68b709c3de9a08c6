"""The port's copies of ``core/theory.py`` and ``core/refqueue.py`` against
the reference's.

Tolerance: none.  The copies run the same float64 host arithmetic, so the
closed forms must be equal, and the oracle queue's assignment log equal
event for event (and equal to the port's array core's, as
tests/test_fastcore.py holds the reference's).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro.core import dls as jdls
from repro.core import engine as jengine
from repro.core import refqueue as jrefqueue
from repro.core import simulator as jsim
from repro.core import theory as jtheory
from repro_torch.core import dls, engine, rdlb, refqueue, simulator, theory

SCENARIO_KINDS = ("fail_stop", "count_fail_stop", "straggler",
                  "msg_latency")
TECHNIQUES = ("STATIC", "SS", "FSC", "GSS", "FAC", "AWF-B", "AF")


def test_theory_closed_forms_equal_reference():
    """E[T] (exact and first order), H_T, H_C and the break-even against
    checkpointing over a grid of (P, N, failure rate, C)."""
    grid = itertools.product((2, 4, 16, 256, 1024),        # q = P
                             (1, 10, 100, 4096),           # n tasks a PE
                             (1e-6, 1e-4, 1e-2, 0.5),      # lambda
                             (0.001, 0.5))                 # t
    for q, n, lam, t in grid:
        for name in ("expected_time_one_failure",
                     "expected_time_first_order", "rdlb_overhead",
                     "checkpoint_crossover"):
            assert getattr(theory, name)(n, t, q, lam) == \
                getattr(jtheory, name)(n, t, q, lam), (name, q, n, lam, t)
        assert theory.t_no_failure(n, t) == jtheory.t_no_failure(n, t)
        for C in (1e-3, 1.0, 60.0):
            assert theory.checkpoint_overhead(lam, C) == \
                jtheory.checkpoint_overhead(lam, C)
            assert theory.rdlb_beats_checkpointing(n, t, q, lam, C) == \
                jtheory.rdlb_beats_checkpointing(n, t, q, lam, C)
    assert theory.monte_carlo_one_failure(100, 0.01, 8, 0.05, reps=4000,
                                          seed=3) == \
        jtheory.monte_carlo_one_failure(100, 0.01, 8, 0.05, reps=4000,
                                        seed=3)
    with pytest.raises(ValueError):
        theory.expected_time_one_failure(10, 0.1, 1, 0.01)


def _workers(eng_mod, kind, P):
    """Engine workers for one paper-perturbation kind (PE 0 survives)."""
    ws = [eng_mod.EngineWorker(w) for w in range(P)]
    for w in range(1, P, 2):
        if kind == "fail_stop":
            ws[w].fail_time = 0.2 * w
        elif kind == "count_fail_stop":
            ws[w].fail_after_tasks = 4 * w
        elif kind == "straggler":
            ws[w].speed = 0.25
        else:
            ws[w].msg_latency = 0.05
    return ws


def _run(mods, queue_cls, technique, kind, tt, *, P, rdlb_on):
    d, e, s = mods
    tech = d.make_technique(technique, len(tt), P, seed=0)
    q = queue_cls(len(tt), tech, rdlb_enabled=rdlb_on)
    st = e.Engine(q, _workers(e, kind, P), s.SimBackend(tt), h=1e-4).run()
    log = [(c.start, c.size, c.pe, c.seq, c.duplicate, c.origin_seq)
           for c in st.assignment_log]
    done = set(np.flatnonzero(
        np.asarray(q.flags) == rdlb.Flag.FINISHED).tolist())
    return log, done, (st.hung, st.n_finished, st.n_assignments,
                       st.n_duplicates, st.wasted_tasks, st.t_virtual)


@pytest.mark.parametrize("rdlb_on", [True, False], ids=["rdlb", "no_rdlb"])
@pytest.mark.parametrize("kind", SCENARIO_KINDS)
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_reference_queue_log_equals_reference(technique, kind, rdlb_on):
    """The copied ``ReferenceQueue`` gives the reference's assignment log,
    completion set and counters, and so does the port's array core."""
    rng = np.random.default_rng(7)
    tt = np.abs(rng.normal(0.02, 0.008, 120)) + 1e-4
    port = (dls, engine, simulator)
    ref = (jdls, jengine, jsim)
    got = _run(port, refqueue.ReferenceQueue, technique, kind, tt, P=5,
               rdlb_on=rdlb_on)
    want = _run(ref, jrefqueue.ReferenceQueue, technique, kind, tt, P=5,
                rdlb_on=rdlb_on)
    core = _run(port, rdlb.RobustQueue, technique, kind, tt, P=5,
                rdlb_on=rdlb_on)
    assert got == want
    assert core[:2] == got[:2] and core[2][:5] == got[2][:5]
