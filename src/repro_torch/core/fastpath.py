"""Vectorized fast-forward for the virtual-time event loop.

``Engine.run()`` is an exact discrete-event simulation: every chunk costs
four heap events and one or two serialized master transactions.  For the
regimes the paper's scalability theory lives in — equal tasks, homogeneous
PEs, a fixed-chunk technique (SS / STATIC / mFSC / FSC), which is exactly
where chunk counts explode (SS at N=10⁶ is a million transactions) — the
event order is provably round-robin:

  * all live workers share one (speed, latency), so within a round the
    master serves report arrivals in worker order, and with ``h > 0``
    master end-times are strictly increasing;
  * chunk costs are (ulp-)equal, so a worker's next arrival never
    overtakes a peer's earlier one (cross-round order is preserved);
  * the queue never runs dry inside the window, so no barrier, poll, or
    rDLB re-issue event can occur.

Under those checked conditions the whole window collapses into a
max-plus recurrence per round:  ``M_w = max(A_w, M_{w-1}) + h`` with
``A_w = M'_w + 2·lat + cost_w`` — one ``np.maximum.accumulate`` per
round instead of ~4·P heap operations.  The queue is updated in one bulk
transaction (``RobustQueue.commit_fast_forward``), technique feedback is
merged with a closed-form Welford batch update, and the engine's normal
scalar event loop takes over for the tail (the last in-flight round, the
final partial chunks, and the rDLB end-of-loop duplicates), seeded with
the in-flight COMPLETE events.

Fast-forward is an OPTIMIZATION, not a semantics change: the assignment
log and completion set are identical to the scalar loop (and to the
pure-Python ``ReferenceQueue`` oracle) — asserted across techniques and
scenarios in tests/test_fastcore.py.  Virtual timestamps may differ from
the scalar loop by floating-point reassociation only (last-ulp).

Anything outside the window — perturbed workers, adaptive policies,
feedback-dependent techniques, varying task costs, real-executing
backends — simply declines fast-forward and runs the scalar loop
unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import rdlb


@dataclasses.dataclass
class Handoff:
    """State the scalar event loop resumes from after a fast-forward."""
    complete_times: np.ndarray   # per worker: COMPLETE instant, in flight
    inflight_seqs: np.ndarray    # per worker: seq of the in-flight chunk
    master_free: float           # master busy-until after the last round
    n_chunks: int                # chunks fast-forwarded (metrics)


def _vector_costs(backend, N: int):
    """The backend's per-task nominal costs as a prefix-sum array, or
    None when the backend cannot guarantee ``cost()`` ≡ prefix sums."""
    from repro_torch.core import simulator  # engine<->simulator: import lazily
    if type(backend).cost is not simulator.SimBackend.cost:
        return None
    ctime = getattr(backend, "ctime", None)
    if not isinstance(ctime, np.ndarray) or len(ctime) != N + 1:
        return None
    return ctime


def fast_forward(eng) -> "Handoff | None":
    """Try to fast-forward ``eng`` from a fresh queue.  Returns None when
    any eligibility condition fails (the scalar loop then runs alone)."""
    from repro_torch.core import engine as em   # lazy: engine imports fastpath
    q = eng.queue
    if type(q) is not rdlb.RobustQueue or q._seq != 0 or q.done:
        return None
    if eng.adaptive is not None or eng.h <= 0.0:
        return None
    b = eng.backend
    if (type(b).execute is not em.WorkerBackend.execute
            or type(b).commit is not em.WorkerBackend.commit):
        return None                       # results matter: stay scalar
    ctime = _vector_costs(b, q.N)
    if ctime is None:
        return None
    ws = eng.workers
    P = len(ws)
    if P < 1 or any(w.wid != i for i, w in enumerate(ws)):
        return None
    speed, lat = ws[0].speed, ws[0].msg_latency
    if speed <= 0.0:
        return None
    for w in ws:
        if (not w.alive or w.fail_time is not None
                or w.fail_after_tasks is not None or w.tasks_done
                or w.speed != speed or w.msg_latency != lat):
            return None
    tech = q.technique
    if getattr(tech, "barrier_per_batch", False) or len(tech.stats) < P:
        return None
    c = tech.fixed_chunk()
    if c is None or c < 1:
        return None
    # K assignment rounds (incl. the initial one), leaving at least
    # c·(P+1) tasks so every windowed chunk is full-size and the queue
    # never runs dry (no re-issue, no barrier, no None from request)
    K = (q.N - c * (P + 1)) // (c * P)
    if K < 2:
        return None
    n_chunks = K * P
    n_tasks = n_chunks * c
    # (near-)uniform task costs: the round-robin order proof needs the
    # per-chunk cost spread to vanish against the master's h spacing
    d = np.diff(ctime[:n_tasks + 1])
    dmin, dmax = float(d.min()), float(d.max())
    if not (np.isfinite(dmin) and np.isfinite(dmax)) or dmin < 0.0:
        return None
    if (dmax - dmin) * c >= eng.h * 1e-6:
        return None

    h = eng.h
    starts = (np.arange(n_chunks, dtype=np.int64) * c).reshape(K, P)
    compute = (ctime[starts + c] - ctime[starts]) / speed    # [K, P]
    # master recurrence, one vector op per round:
    #   M_w = max(A_w, M_{w-1}) + h   ==   cummax(A_w - w·h) + (w+1)·h
    offm = np.arange(P) * h
    off = offm + h
    arrive = np.full(P, lat)              # round 0: REQ_ARRIVE at t=lat
    m_init = 0.0
    M = M0 = None
    for r in range(K):
        cm = np.maximum.accumulate(arrive - offm)
        if m_init > 0.0:
            np.maximum(cm, m_init, out=cm)
        M = cm + off                      # this round's master end-times
        if r == 0:
            M0 = M                        # first assignment per worker —
                                          # the trace span's left edge
        m_init = float(M[-1])
        done = (M + lat) + compute[r]
        arrive = done + lat               # next round's REP_ARRIVE
    done_last = (M + lat) + compute[K - 1]
    if float(done_last[-1]) + lat > eng.horizon:
        return None                       # would hang: let scalar decide

    # --- commit: queue bulk transaction -----------------------------------
    q.commit_fast_forward(P=P, c=c, n_rounds=K, n_reported_rounds=K - 1)

    # --- commit: worker accounting (oracle updates these at assign time) --
    busy = compute.sum(axis=0)
    for i, w in enumerate(ws):
        w.busy = float(busy[i])
        w.tasks_done = n_chunks // P * c
        w.last_done = float(done_last[i])
        eng.by_worker[i] = w.tasks_done

    # --- commit: technique feedback (reported rounds only) ----------------
    if eng.record_feedback and K > 1:
        xs = compute[:K - 1] / c          # per-iteration time samples
        n_b = K - 1
        mu_b = xs.mean(axis=0)
        m2_b = ((xs - mu_b) ** 2).sum(axis=0)
        comp_sum = compute[:K - 1].sum(axis=0)
        sched_inc = n_b * (2.0 * lat + h)
        for i in range(P):
            s = tech.stats[i]
            s.iters_done += n_b * c
            s.compute_time += float(comp_sum[i])
            s.sched_time += sched_inc
            # Welford batch merge (Chan et al.) — closed form for n_b
            # samples; equals the sequential update up to rounding
            n_a = s.n_samples
            n = n_a + n_b
            delta = float(mu_b[i]) - s.mean_iter_time
            s.mean_iter_time += delta * n_b / n
            s.m2_iter_time += float(m2_b[i]) + delta * delta * n_a * n_b / n
            s.n_samples = n

    # --- trace: one synthesized bulk span per worker ----------------------
    # Tracing never forces the scalar loop: the whole window appears as P
    # EV_FF_SPAN records — aux = chunks fast-forwarded, size = tasks
    # assigned (the by_worker credit), start = tasks bulk-FINISHED here
    # ((K-1)·c; the in-flight round reports as ordinary EV_REPORTs once
    # the scalar loop resumes).
    if eng.trace is not None:
        from repro_torch.core import trace as trc
        span0 = M0 + lat                  # first chunk reaches each worker
        for i in range(P):
            eng.trace.event(trc.EV_FF_SPAN, float(span0[i]), i,
                            seq=int(i), start=(K - 1) * c, size=K * c,
                            aux=K, dt=float(done_last[i] - span0[i]))

    seqs = np.arange((K - 1) * P, K * P, dtype=np.int64)
    return Handoff(complete_times=done_last, inflight_seqs=seqs,
                   master_free=m_init, n_chunks=n_chunks)
