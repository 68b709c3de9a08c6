"""Device-resident batched simulation of the homogeneous fixed-chunk regime.

``core/fastpath.py`` collapses the virtual-time event loop into a max-plus
recurrence per round — but it is still ONE simulation per Python call, and
the adaptive portfolio sweep / resilience grids need THOUSANDS of them
(candidate × perturbation draw).  This module runs the recurrence as
batched PyTorch ops over a leading (candidate × draw) axis: every state
field is a ``[B, P]`` or ``[B]`` tensor on one device (the card unless
the caller asks for the CPU), and every step below is one set of ops over
the whole batch:

  * the ROUND phase is a loop of ``R_max`` steps over assignment rounds
    carrying (arrival times, in-flight chunks, liveness): per round one
    ``cummax`` computes every master end-time
    ``M_w = max(A_w, M_{w-1}) + h`` and a cumulative-sum over the
    assignment mask hands out the next chunks in serve order.  Unlike
    fastpath, deaths are handled in-recurrence: a worker whose chunk
    completion falls at-or-after its fail-stop instant drops out holding
    the chunk (the chunk is LOST, exactly as in ``Engine.run``);
  * the no-failure TAIL (last in-flight round, final partial chunks, the
    rDLB end-of-loop duplicates) is closed-form: one more cummax round,
    a sorted cummax over the remainder reports, and an O(remainder)
    micro-loop reproducing the re-issue ring pointer;
  * the FAILURE tail runs an exact transaction-phase loop of ``T_max``
    steps: each step serves the earliest pending arrival (argmin = the
    event heap), reproducing report/commit/first-completion-wins, the
    re-issue ring's oldest-first rotating pointer, duplicate-slot leaks
    on dup-holder death, and the non-robust Fig.-1b hang
    (``t_par = inf``).

Times are float64, chunk indices int32 and task counts int64.  Every loop
runs its full budget, each step masked per element (``active`` / ``go`` /
its own trip count), so an element's result never depends on the rest of
its batch.  The budgets are computed host-side from the batch's worst
case; an element that exhausts its budget comes back with ``valid=False``
and the caller MUST re-run it on the scalar engine — the batched path
degrades to the oracle, never silently mis-simulates.

Parity boundary (asserted in tests/test_torch_devicesim.py): within the
lowered regime — virtual mode, fixed-chunk technique (SS / STATIC /
mFSC / FSC), homogeneous alive workers, uncapped duplicates,
(near-)uniform task costs, ``h > 0`` — ``t_par``, chunk/duplicate/waste
counts and per-worker accounting match ``Engine.run`` to float64
round-off.  Anything else (``lower_run`` returns a reason string)
declines and runs the scalar loop unchanged.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device

_BIG = 2 ** 30                  # "no chunk" sentinel in seq space
_NEVER = np.float64(np.inf)     # "never fails"
_INF = float("inf")

# ------------------------------------------------------- batch telemetry
_lock = threading.Lock()
_BATCHES: dict[str, int] = {}


def batch_calls(device_type: Optional[str] = None):
    """Batched calls run so far, per device type ("cuda", "cpu"), or the
    count of one type."""
    with _lock:
        return (_BATCHES.get(device_type, 0) if device_type is not None
                else dict(_BATCHES))


def reset_batch_calls() -> None:
    """Set every batched-call count to 0."""
    with _lock:
        _BATCHES.clear()


# ---------------------------------------------------------------- lowering
@dataclasses.dataclass
class DeviceLowering:
    """One run lowered to batched-parameter form (host numpy arrays)."""
    chunk_costs: np.ndarray      # [C] nominal compute seconds per chunk
    chunk_sizes: np.ndarray      # [C] tasks per chunk (last may be partial)
    n_chunks: int
    chunk: int                   # the technique's fixed chunk size
    P: int
    h: float
    lat: float
    speed: float
    rdlb: bool
    fail_time: np.ndarray        # [P] fail-stop instants (inf = never)
    N: int
    horizon: float
    technique: str = ""
    label: str = ""


def lower_run(spec, task_times, *,
              technique=None) -> tuple[Optional[DeviceLowering], str]:
    """Try to lower ``(spec, task_times)`` into device-batched form.

    Returns ``(lowering, "")`` or ``(None, reason)``.  The checks mirror
    ``fastpath.fast_forward`` eligibility, extended to whole runs:
    fail-stop DRAWS are allowed (they batch as the perturbation axis),
    heterogeneity/adaptivity/barriers/finite dup caps are not.
    """
    from repro_torch import api   # lazy: api imports core

    if spec.execution.mode != "virtual":
        return None, f"mode={spec.execution.mode!r} (need virtual)"
    if spec.adaptive.enabled:
        return None, "adaptive policy enabled"
    h = float(spec.execution.h)
    if h <= 0.0:
        return None, "h <= 0"
    if spec.robustness.max_duplicates is not None:
        return None, "finite max_duplicates (poll/cap paths are scalar-only)"
    times = np.asarray(task_times, dtype=np.float64)
    N = len(times)
    if N < 1:
        return None, "empty workload"
    ws = spec.cluster.worker_specs()
    P = len(ws)
    if P < 1:
        return None, "no workers"
    speed, lat = float(ws[0].speed), float(ws[0].msg_latency)
    if speed <= 0.0:
        return None, "non-positive speed"
    fail = np.full(P, _NEVER)
    for i, w in enumerate(ws):
        if not w.alive:
            return None, f"worker {i} starts dead"
        if w.fail_after_tasks is not None:
            return None, f"worker {i} has count-based fail-stop"
        if w.speed != speed or w.msg_latency != lat:
            return None, "heterogeneous workers"
        stops = [t for t in (w.fail_time, w.hang_time) if t is not None]
        if stops:
            fail[i] = min(stops)
    tech = technique
    if tech is None:
        tech = api.make_scheduler(spec, N)
    if getattr(tech, "barrier_per_batch", False):
        return None, f"{tech.name}: batch-weight barrier technique"
    c = tech.fixed_chunk()
    if c is None or c < 1:
        return None, f"{tech.name}: not a fixed-chunk technique"
    C = -(-N // c)
    # (near-)uniform task costs over all FULL chunks: the round-robin
    # serve-order proof needs the per-chunk spread to vanish against the
    # master's h spacing (same threshold as fastpath).  The final partial
    # chunk is exempt — its ordering is computed exactly in the tail.
    nfull = (C - 1) * c if C > 1 else N
    if nfull > 0:
        d = times[:nfull]
        dmin, dmax = float(d.min()), float(d.max())
        if not (np.isfinite(dmin) and np.isfinite(dmax)) or dmin < 0.0:
            return None, "non-finite/negative task costs"
        if (dmax - dmin) * c >= h * 1e-6:
            return None, "task-cost spread too large for round-robin proof"
    ctime = np.concatenate([[0.0], np.cumsum(times)])
    starts = np.arange(C, dtype=np.int64) * c
    stops = np.minimum(starts + c, N)
    return DeviceLowering(
        chunk_costs=(ctime[stops] - ctime[starts]).astype(np.float64),
        chunk_sizes=(stops - starts).astype(np.int32),
        n_chunks=int(C), chunk=int(c), P=P, h=h, lat=lat, speed=speed,
        rdlb=bool(spec.robustness.rdlb_enabled), fail_time=fail, N=N,
        horizon=float(spec.execution.horizon),
        technique=spec.scheduling.technique,
        label=spec.name or spec.scheduling.technique), ""


# ------------------------------------------------------------ batch result
@dataclasses.dataclass
class DeviceBatchResult:
    """Per-element outputs of one batched device call (host numpy)."""
    t_par: np.ndarray            # [B] (inf = hang)
    hung: np.ndarray             # [B] bool
    valid: np.ndarray            # [B] bool: False -> re-run on the scalar
                                 # engine (budget exhausted / unlowerable)
    n_finished: np.ndarray       # [B]
    n_assignments: np.ndarray    # [B]
    n_duplicates: np.ndarray     # [B]
    wasted_tasks: np.ndarray     # [B]
    pe_busy: np.ndarray          # [B, P]
    pe_idle: np.ndarray          # [B, P]
    tasks_done: np.ndarray       # [B, P]
    last_done: np.ndarray        # [B, P]


# ------------------------------------------------------- per-element consts
class _Const:
    """The batch's per-element constants, and the (technique, chunk)
    gathers.  Tables are flattened [U * C]: a gather reads one cost per
    (element, worker) and never builds a per-element [C] cost row, which
    matters at B x C ~ 10^3 x 10^5."""

    def __init__(self, tech_ix, rdlb, fail, h, lat, speed, t_costs,
                 t_sizes, t_nc, t_N):
        ix = tech_ix.long()
        self.base = ix * t_costs.shape[1]
        self.costs = t_costs.reshape(-1)
        self.sizes = t_sizes.reshape(-1)
        self.nc = t_nc[ix]                      # [B] int32
        self.N = t_N[ix]                        # [B] int64
        self.rdlb, self.fail = rdlb, fail
        self.h, self.lat, self.speed = h, lat, speed
        # the same, broadcast against [B, P] state
        self.h2, self.lat2, self.speed2 = h[:, None], lat[:, None], \
            speed[:, None]

    def _flat(self, i):
        base = self.base if i.dim() == 1 else self.base[:, None]
        return base + i.long()

    def cost_at(self, i):
        return self.costs[self._flat(i)]

    def size_at(self, i):
        return self.sizes[self._flat(i)]

    def clip(self, i):
        """``clip(i, 0, nc - 1)`` per element."""
        top = self.nc - 1 if i.dim() == 1 else (self.nc - 1)[:, None]
        return torch.minimum(i.clamp(min=0), top)


def _get(x, o):
    """``x[b, o[b]]`` for every element b."""
    return x.gather(1, o[:, None]).squeeze(1)


def _put(x, o, v):
    """``x[b, o[b]] = v[b]`` for every element b, in place."""
    x.scatter_(1, o[:, None], v[:, None])


def _i32(x):
    return x.to(torch.int32)


# ------------------------------------------------------------- round phase
def _round_phase(st, c, *, P, R_max, nofail=False):
    """``R_max`` steps over assignment rounds.  ``st`` carries per-worker
    arrival times / in-flight chunks / liveness; each step is one full
    service round: cummax masters, cumsum chunk hand-out, death
    filtering.

    ``nofail`` specializes for elements with no fail-stop draws (the
    clean tails' precondition): the piggyback gate, loss check and death
    bookkeeping vanish from the step."""
    h, lat, speed = c.h2, c.lat2, c.speed2
    neg = torch.full_like(st[0], -_INF)
    inf = torch.full_like(st[0], _INF)
    for _ in range(R_max):
        (arrive, held, first, dead, nxt, mfree, nleft,
         tasks, busy, last_done, n_assign) = st
        part = torch.isfinite(arrive)
        anyp = part.any(1)
        active = (nxt + P <= c.nc) & anyp
        rank = torch.cumsum(part, 1, dtype=torch.int32) - 1
        a = torch.where(part, arrive - rank * h, neg)
        M = torch.maximum(torch.cummax(a, 1).values,
                          mfree[:, None]) + (rank + 1) * h
        # commits: every served report finishes its held chunk (no
        # duplicates can exist inside the window, so every commit wins)
        commit = part & (held >= 0)
        heldc = c.clip(held)
        nleft2 = nleft - torch.where(commit, c.size_at(heldc), 0).sum(1)
        # piggyback gate (round 0 = initial requests: unconditional)
        if nofail:
            take = part
        else:
            take = part & (first | (M < c.fail))
        idx = nxt[:, None] + torch.cumsum(take, 1, dtype=torch.int32) - 1
        idxc = c.clip(idx)
        cost = c.cost_at(idxc) / speed
        done = M + lat + cost
        if nofail:
            ok = take
            dead2 = dead
        else:
            lost = take & (done >= c.fail)
            ok = take & ~lost
            dead2 = dead | lost
        arrive2 = torch.where(ok, done + lat, inf)
        arrive2 = torch.where(part, arrive2, arrive)
        held2 = torch.where(take, idx, torch.where(part, -1, held))
        tasks2 = tasks + torch.where(ok, c.size_at(idxc), 0)
        busy2 = busy + torch.where(ok, cost, 0.0)
        last2 = torch.where(ok, done, last_done)
        mfree2 = torch.where(part, M, neg).amax(1)
        mfree2 = torch.where(anyp, mfree2, mfree)
        ntake = take.sum(1)
        new = (arrive2, held2, torch.zeros_like(first), dead2,
               _i32(nxt + ntake), mfree2, nleft2, tasks2, busy2, last2,
               n_assign + ntake)
        st = tuple(torch.where(active.view((-1,) + (1,) * (n.dim() - 1)),
                               n, o) for n, o in zip(new, st))
    return st


# ---------------------------------------------------- clean (no-fail) tail
def _ring_next(candseq, ptr):
    """The re-issue ring's next target: the least candidate seq at or
    past ``ptr``, else the least overall (``_BIG`` when none)."""
    ge = torch.where(candseq >= ptr[:, None], candseq, _BIG)
    s1 = ge.amin(1)
    return torch.where(s1 == _BIG, candseq.amin(1), s1)


def _round_b(st_b, c, *, P, r, M_B, orderB):
    """Round B: the first r-1 served remainder reports each trigger one
    more rDLB duplicate (queue not yet done) — an O(r) micro-loop walks
    the re-issue ring pointer exactly.  Shared by both clean tails.  The
    loop runs to P; step j acts only on elements with ``j < r - 1``."""
    candseq, ptr, dupmin, tasks, busy, last_done, n_assign, n_dups = st_b
    trip = torch.clamp(r - 1, 0, P)
    big = torch.full_like(ptr, _BIG)
    for j in range(P):
        go = j < trip
        o = orderB[:, j]
        _put(candseq, o, torch.where(go, big, _get(candseq, o)))
        s2 = _ring_next(candseq, ptr)        # its chunk committed first
        can = go & c.rdlb & (s2 != _BIG)
        s2c = c.clip(s2)
        dc = c.cost_at(s2c) / c.speed
        dn = M_B[:, j] + c.lat + dc
        tasks.scatter_add_(1, o[:, None],
                           torch.where(can, c.size_at(s2c), 0)[:, None]
                           .to(tasks.dtype))
        busy.scatter_add_(1, o[:, None], torch.where(can, dc, 0.0)[:, None])
        _put(last_done, o, torch.where(can, dn, _get(last_done, o)))
        dupmin = torch.where(can, torch.minimum(dupmin, dn + c.lat), dupmin)
        ptr = torch.where(can, _i32(s2 + 1), ptr)
        n_assign = n_assign + can
        n_dups = n_dups + can
    return candseq, ptr, dupmin, tasks, busy, last_done, n_assign, n_dups


def _phase_valid(valid, arrive, arrB, dupmin, r):
    """Phase separation: remainder reports strictly follow round A, dup
    reports follow every original report (ties resolve to the original
    via heap push order, hence >=)."""
    maxA = arrive.amax(1)
    minB = arrB.amin(1)
    maxorig = torch.maximum(maxA, torch.where(
        torch.isfinite(arrB), arrB, -_INF).amax(1))
    return valid & ((r == 0) | (minB >= maxA)) & (dupmin >= maxorig)


def _serve_order(arrive):
    """Serve order of the reports ``arrive`` [B, P]: ascending, equal
    times in worker-index order (a stable sort, on every device) — the
    event heap's tie-break on push order."""
    return torch.sort(arrive, dim=1, stable=True).indices


def _round_b_masters(arrB, M_last, r, w, h):
    """Round B's serve order and its masters."""
    orderB = _serve_order(arrB)
    sortB = torch.where(w < r[:, None], arrB.gather(1, orderB) - w * h,
                        -_INF)
    M_B = torch.maximum(torch.cummax(sortB, 1).values,
                        M_last[:, None]) + (w + 1) * h
    return orderB, M_B


def _clean_tail(st, c, *, P):
    """General tail for failure-free elements: round A serves the P
    in-flight reports in exact arrival order (:func:`_serve_order`),
    handing the first r serve-ranks the
    remainder originals and walking the re-issue ring for the rDLB
    duplicates; then round B serves the r remainder reports the same way.
    An O(P) micro-loop reproduces the ring pointer exactly — correct even
    when the final partial chunk is already in flight and reports out of
    index order, at O(P^2) cost per element.

    Validity (-> scalar fallback, never a wrong answer) additionally
    requires phase separation: every remainder report must arrive after
    all round-A reports, and every duplicate report after all original
    reports — guaranteed for uniform full chunks, but a very cheap
    partial chunk against a large P*h master span can violate it."""
    (arrive, held, first, dead, nxt, mfree, nleft,
     tasks, busy, last_done, n_assign) = st
    h, lat = c.h2, c.lat
    valid = (~first.any(1)) & (nxt + P > c.nc)   # >=1 round ran, none left
    r = c.nc - nxt                               # remainder chunks, < P
    w = torch.arange(P, dtype=torch.int32, device=arrive.device)[None, :]

    # ---- round A: serve the P in-flight reports in arrival order
    orderA = _serve_order(arrive)
    Ms = torch.maximum(torch.cummax(arrive.gather(1, orderA) - w * h,
                                    1).values,
                       mfree[:, None]) + (w + 1) * h  # masters, serve order

    candseq = _i32(torch.where(held >= 0, held, _BIG))
    ptr = torch.zeros_like(nxt)
    arrB = torch.full_like(arrive, _INF)
    dupmin = torch.full_like(mfree, _INF)
    tasks, busy, last_done = tasks.clone(), busy.clone(), last_done.clone()
    n_dups = torch.zeros_like(n_assign)
    big = torch.full_like(ptr, _BIG)
    inf = torch.full_like(mfree, _INF)
    for k in range(P):
        o = orderA[:, k]
        _put(candseq, o, big)                # o's held chunk commits
        is_orig = k < r
        done_after = (r == 0) & (k == P - 1)  # queue done at last commit
        s2 = _ring_next(candseq, ptr)
        can_dup = c.rdlb & (~is_orig) & (~done_after) & (s2 != _BIG)
        tgt = torch.where(is_orig, _i32(nxt + k), s2)
        tgtc = c.clip(tgt)
        cost = c.cost_at(tgtc) / c.speed
        dn = Ms[:, k] + lat + cost
        assigned = is_orig | can_dup
        tasks.scatter_add_(1, o[:, None],
                           torch.where(assigned, c.size_at(tgtc), 0)[:, None]
                           .to(tasks.dtype))
        busy.scatter_add_(1, o[:, None],
                          torch.where(assigned, cost, 0.0)[:, None])
        _put(last_done, o, torch.where(assigned, dn, _get(last_done, o)))
        _put(arrB, o, torch.where(is_orig, dn + lat, inf))
        dupmin = torch.where(can_dup, torch.minimum(dupmin, dn + lat),
                             dupmin)
        _put(candseq, o, torch.where(is_orig, tgt, big))
        ptr = torch.where(can_dup, _i32(s2 + 1), ptr)
        n_assign = n_assign + assigned
        n_dups = n_dups + can_dup

    # ---- round B: the r remainder reports, in exact arrival order
    orderB, M_B = _round_b_masters(arrB, Ms[:, P - 1], r, w, h)
    # t_par: r == 0 completes at round A's last commit, else at the last
    # remainder report's master transaction
    t_par = torch.where(r >= 1, _get(M_B, torch.clamp(r - 1, 0, P - 1)
                                     .long()), Ms[:, P - 1])
    carry = (candseq, ptr, dupmin, tasks, busy, last_done, n_assign, n_dups)
    (candseq, ptr, dupmin, tasks, busy, last_done, n_assign, n_dups) = \
        _round_b(carry, c, P=P, r=r, M_B=M_B, orderB=orderB)
    valid = _phase_valid(valid, arrive, arrB, dupmin, r)
    zero = torch.zeros_like(n_assign)
    return (t_par, torch.zeros_like(valid), valid, nleft * 0,
            n_assign, n_dups, zero, tasks, busy, last_done, ~dead)


def _clean_tail_sorted(st, c, *, P):
    """Fully-vectorized tail for failure-free elements whose round-A serve
    order provably equals worker-index order — the common case where the
    in-flight chunks are all FULL (host-gated: nc % P != 0, or the last
    chunk is full; device-checked: ``arrive`` is non-decreasing).  No
    O(P) micro-loop in round A: one cummax, the re-issue ring closed-form
    (at serve rank w >= r the cyclic-min candidate is worker w+1's held
    chunk; rank P-1 re-issues the first remainder original).  Round B
    (the r remainder reports, which MAY be out of order — the partial
    chunk is cheap) reuses the exact O(r) ring walk.

    Same phase-separation validity contract as :func:`_clean_tail`."""
    (arrive, held, first, dead, nxt, mfree, nleft,
     tasks, busy, last_done, n_assign) = st
    h, lat = c.h2, c.lat2
    valid = (~first.any(1)) & (nxt + P > c.nc)   # >=1 round ran, none left
    valid = valid & (torch.diff(arrive, dim=1) >= 0.0).all(1)  # sorted
    r = c.nc - nxt                               # remainder chunks, < P
    w = torch.arange(P, dtype=torch.int32, device=arrive.device)[None, :]
    r2, nxt2 = r[:, None], nxt[:, None]
    rdlb = c.rdlb[:, None]

    # ---- round A, serve order == index order
    M_A = torch.maximum(torch.cummax(arrive - w * h, 1).values,
                        mfree[:, None]) + (w + 1) * h
    is_orig = w < r2
    done_after = (r2 == 0) & (w == P - 1)     # queue done at last commit
    # ring closed-form: ptr starts at 0; the cyclic-min unfinished holder
    # at rank w is worker w+1 (chunks nxt-P+w+1 ascend), until rank P-1
    # where only the round's own originals (nxt..nxt+r-1) remain
    dup_t = torch.where(w < P - 1, torch.roll(held, -1, 1), nxt2)
    can_dup = rdlb & ~is_orig & ~done_after
    tgt = torch.where(is_orig, nxt2 + w, dup_t)
    tgtc = c.clip(tgt)
    cost = c.cost_at(tgtc) / c.speed2
    dn = M_A + lat + cost
    assigned = is_orig | can_dup
    tasks = tasks + torch.where(assigned, c.size_at(tgtc), 0)
    busy = busy + torch.where(assigned, cost, 0.0)
    last_done = torch.where(assigned, dn, last_done)
    arrB = torch.where(is_orig, dn + lat, _INF)
    dupmin = torch.where(can_dup, dn + lat, _INF).amin(1)
    n_assign = n_assign + assigned.sum(1)
    n_dups = can_dup.sum(1)

    # ---- round B: the r remainder reports, in exact arrival order
    orderB, M_B = _round_b_masters(arrB, M_A[:, P - 1], r, w, h)
    t_par = torch.where(r >= 1, _get(M_B, torch.clamp(r - 1, 0, P - 1)
                                     .long()), M_A[:, P - 1])

    # ring state after round A: originals nxt+w live at workers w < r;
    # rank P-1's re-issue advanced the pointer past nxt
    candseq = _i32(torch.where(is_orig, nxt2 + w, _BIG))
    ptr = _i32(torch.where(c.rdlb & (r >= 1), nxt + 1, 0))
    carry = (candseq, ptr, dupmin, tasks, busy, last_done, n_assign, n_dups)
    (candseq, ptr, dupmin, tasks, busy, last_done, n_assign, n_dups) = \
        _round_b(carry, c, P=P, r=r, M_B=M_B, orderB=orderB)
    valid = _phase_valid(valid, arrive, arrB, dupmin, r)
    zero = torch.zeros_like(n_assign)
    return (t_par, torch.zeros_like(valid), valid, nleft * 0,
            n_assign, n_dups, zero, tasks, busy, last_done, ~dead)


# -------------------------------------------------- transaction-phase tail
def _txn_tail(st, c, *, P, T_max):
    """Exact event-at-a-time tail for elements with failure draws: each
    of ``T_max`` steps serves the earliest pending arrival (the event
    heap's next master transaction) — commit / first-completion-wins /
    ring re-issue / duplicate-slot leak / retirement / Fig.-1b hang
    semantics exactly as ``Engine.run``."""
    (arrive, held, first, dead, nxt, mfree, nleft,
     tasks, busy, last_done, n_assign) = st
    dev = arrive.device
    widx = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    isdup = torch.zeros_like(first)
    hfin = torch.zeros_like(first)            # holding an already-won chunk
    dupc = torch.zeros_like(held)             # live dups, at the ORIGINAL
                                              # holder's slot (leaks when a
                                              # dup holder dies — as rdlb's
                                              # _c_dups does)
    ptr = torch.zeros_like(nxt)               # re-issue ring pointer (seq)
    t_par = torch.full_like(mfree, _INF)
    fin = torch.zeros_like(first[:, 0])
    hung = torch.zeros_like(fin)
    n_dups = torch.zeros_like(n_assign)
    wasted = torch.zeros_like(nleft)
    inf = torch.full_like(arrive, _INF)
    for _ in range(T_max):
        pend = torch.isfinite(arrive)
        anyp = pend.any(1)
        live = ~(fin | hung)
        go = live & anyp
        newhang = live & ~anyp & (nleft > 0)
        # argmin returns the lowest index among equal arrivals: the
        # heap's push-order tie-break
        i = torch.where(pend, arrive, inf).argmin(1)
        tm = torch.maximum(_get(arrive, i), mfree) + c.h
        isreq = _get(first, i)
        held_i = _get(held, i)

        # ---- report service (no-op fields when isreq)
        rep = go & ~isreq & (held_i >= 0)
        ssz = c.size_at(c.clip(held_i))
        hfin_i = _get(hfin, i)
        win = rep & ~hfin_i
        lose = rep & hfin_i
        nleft2 = nleft - torch.where(win, ssz, 0)
        wasted2 = wasted + torch.where(lose, ssz, 0)
        # first-completion-wins: other holders of s now hold dead weight
        same = held == held_i[:, None]
        hfin2 = hfin | (win[:, None] & same)
        mine = widx == i[:, None]
        # a live dup's report frees its slot at the ORIGINAL holder
        oslot = same & ~isdup & (held >= 0) & ~mine
        dec = rep & _get(isdup, i)
        dupc2 = dupc - (dec[:, None] & oslot).to(dupc.dtype)
        # clear the reporter's slot
        clear = (go & ~isreq)[:, None] & mine
        held2 = torch.where(clear, -1, held)
        isdup2 = isdup & ~clear
        hfin2 = hfin2 & ~clear
        newly_done = win & (nleft2 == 0)
        fin2 = fin | (go & newly_done)
        t_par2 = torch.where(go & newly_done, tm, t_par)

        # ---- assignment (REQ_ARRIVE always assigns; a report piggybacks
        # only while the worker is alive at the master's end instant)
        fail_i = _get(c.fail, i)
        want = isreq | (~newly_done & (tm < fail_i))
        have_orig = nxt < c.nc
        cand = (held2 >= 0) & ~isdup2 & ~hfin2
        s2 = _ring_next(_i32(torch.where(cand, held2, _BIG)), ptr)
        can_dup = c.rdlb & (s2 != _BIG)
        assigned = go & want & (have_orig | can_dup)
        as_dup = assigned & ~have_orig
        tgt = torch.where(have_orig, nxt, s2)
        tgtc = c.clip(tgt)
        ptr2 = torch.where(as_dup, _i32(s2 + 1), ptr)
        dupc2 = dupc2 + (as_dup[:, None] & (held2 == s2[:, None])
                         & ~isdup2).to(dupc.dtype)
        cost = c.cost_at(tgtc) / c.speed
        done = tm + c.lat + cost
        lostx = assigned & (done >= fail_i)
        okx = assigned & ~lostx
        put = assigned[:, None] & mine
        ok_mine = okx[:, None] & mine
        gom = go[:, None] & mine
        held = torch.where(put, tgt[:, None], held2)
        isdup = torch.where(put, as_dup[:, None], isdup2)
        dead = dead | (lostx[:, None] & mine)
        arrive = torch.where(gom, torch.where(okx, done + c.lat,
                                              _INF)[:, None], arrive)
        first = first & ~gom
        tasks = tasks + torch.where(ok_mine, c.size_at(tgtc)[:, None], 0)
        busy = busy + torch.where(ok_mine, cost[:, None], 0.0)
        last_done = torch.where(ok_mine, done[:, None], last_done)
        hfin, dupc, ptr = hfin2, dupc2, ptr2
        nxt = torch.where(assigned & have_orig, _i32(nxt + 1), nxt)
        mfree = torch.where(go, tm, mfree)
        nleft = torch.where(go, nleft2, nleft)
        t_par, fin = t_par2, fin2
        hung = hung | newhang
        n_assign = n_assign + assigned
        n_dups = n_dups + as_dup
        wasted = torch.where(go, wasted2, wasted)
    t_par = torch.where(hung, _INF, t_par)
    return (t_par, hung, fin | hung, nleft, n_assign, n_dups, wasted,
            tasks, busy, last_done, ~dead)


# ------------------------------------------------------------ one batch
_TAILS = ("sorted", "general", "txn")


def _batch(tech_ix, rdlb, fail, h, lat, speed, t_costs, t_sizes, t_nc,
           t_N, *, P, R_max, T_max, tail):
    """Simulate B elements (tensors on one device, leading axis B) with
    scan budgets ``R_max`` / ``T_max`` and the given tail.  Returns the
    per-element (t_par, hung, valid, nleft, n_assign, n_dups, wasted,
    tasks, busy, last_done, alive) tensors."""
    if tail not in _TAILS:
        raise ValueError(f"tail must be one of {_TAILS}, not {tail!r}")
    dev = fail.device
    with _lock:
        _BATCHES[dev.type] = _BATCHES.get(dev.type, 0) + 1
    c = _Const(tech_ix, rdlb, fail, h, lat, speed, t_costs, t_sizes,
               t_nc, t_N)
    B = fail.shape[0]
    f64, i32, i64 = torch.float64, torch.int32, torch.int64
    st = (lat[:, None].expand(B, P).clone(),                 # arrive (REQ)
          torch.full((B, P), -1, dtype=i32, device=dev),    # held chunk
          torch.ones((B, P), dtype=torch.bool, device=dev),  # first request
          torch.zeros((B, P), dtype=torch.bool, device=dev),  # dead
          torch.zeros(B, dtype=i32, device=dev),            # next_chunk
          torch.zeros(B, dtype=f64, device=dev),            # master_free
          c.N.to(i64),                                      # tasks left
          torch.zeros((B, P), dtype=i64, device=dev),       # tasks_done
          torch.zeros((B, P), dtype=f64, device=dev),       # busy
          torch.zeros((B, P), dtype=f64, device=dev),       # last_done
          torch.zeros(B, dtype=i64, device=dev))            # n_assignments
    st = _round_phase(st, c, P=P, R_max=R_max, nofail=(tail != "txn"))
    if tail == "sorted":
        return _clean_tail_sorted(st, c, P=P)
    if tail == "general":
        return _clean_tail(st, c, P=P)
    return _txn_tail(st, c, P=P, T_max=T_max)


def _bucket(n: int) -> int:
    """Round scan budgets up to sub-octave buckets: bounded recompilation,
    small masked scan-step overhead (a plain power-of-2 budget wastes up
    to 2x).  Small budgets (cheap to recompile, hot in adaptive sweeps)
    use quarter-octave steps, large ones (benchmark/Monte-Carlo scale,
    where wasted steps dominate compile time) eighth-octave."""
    if n <= 16:
        return 16
    b = 16
    while b < n:
        b *= 2
    q = b // 8 if b < 256 else b // 16
    return -(-n // q) * q


# --------------------------------------------------------------- host API
def simulate_many(lowerings: Sequence[DeviceLowering],
                  tech_of: Optional[np.ndarray] = None,
                  fail_times: Optional[np.ndarray] = None,
                  device=None) -> DeviceBatchResult:
    """ONE batched call (well: at most three — failure-free elements take
    a closed-form tail, vectorized when the serve order is provably index
    order and an exact O(P) ring walk otherwise; failure draws take the
    exact transaction loop) over B = len(tech_of) elements, on ``device``
    (``repro_torch.device.resolve``: the card unless the caller passes
    the CPU).

    ``tech_of[b]`` indexes into ``lowerings`` (the candidate axis);
    ``fail_times[b]`` is a per-worker fail-stop draw (inf = never),
    combined (min) with each lowering's own spec-declared instants.
    Defaults: one element per lowering, no extra draws.
    """
    dev = _device.resolve(device)
    if not lowerings:
        raise ValueError("need at least one lowering")
    P = lowerings[0].P
    if any(lo.P != P for lo in lowerings):
        raise ValueError("all lowerings in a batch must share P")
    U = len(lowerings)
    if tech_of is None:
        tech_of = np.arange(U, dtype=np.int32)
    tech_of = np.asarray(tech_of, dtype=np.int32)
    B = len(tech_of)
    spec_fail = np.stack([lo.fail_time for lo in lowerings])[tech_of]
    if fail_times is None:
        fail = spec_fail
    else:
        fail = np.minimum(np.asarray(fail_times, dtype=np.float64),
                          spec_fail)
    C = max(lo.n_chunks for lo in lowerings)
    t_costs = np.zeros((U, C))
    t_sizes = np.zeros((U, C), dtype=np.int32)
    t_nc = np.zeros(U, dtype=np.int32)
    t_N = np.zeros(U, dtype=np.int64)
    for u, lo in enumerate(lowerings):
        t_costs[u, :lo.n_chunks] = lo.chunk_costs
        t_sizes[u, :lo.n_chunks] = lo.chunk_sizes
        t_nc[u] = lo.n_chunks
        t_N[u] = lo.N
    h = np.array([lowerings[u].h for u in tech_of])
    lat = np.array([lowerings[u].lat for u in tech_of])
    speed = np.array([lowerings[u].speed for u in tech_of])
    rdlb = np.array([lowerings[u].rdlb for u in tech_of])
    nc_of = t_nc[tech_of]

    k_of = np.isfinite(fail).sum(axis=1)
    clean_mask = (k_of == 0) & (nc_of >= P)
    # serve order == index order unless P | nc AND the last chunk is
    # partial (then the cheap partial chunk is in flight during the tail's
    # round A and reports early) — those take the O(P) ring-walk tail
    lo_sorted = np.array([(lo.n_chunks % P != 0)
                          or (lo.chunk_sizes[-1] == lo.chunk)
                          for lo in lowerings])
    sorted_mask = clean_mask & lo_sorted[tech_of]

    out = {
        "t_par": np.full(B, np.inf), "hung": np.zeros(B, bool),
        "valid": np.zeros(B, bool), "n_finished": np.zeros(B, np.int64),
        "n_assignments": np.zeros(B, np.int64),
        "n_duplicates": np.zeros(B, np.int64),
        "wasted_tasks": np.zeros(B, np.int64),
        "pe_busy": np.zeros((B, P)), "pe_idle": np.zeros((B, P)),
        "tasks_done": np.zeros((B, P), np.int64),
        "last_done": np.zeros((B, P)),
    }
    alive = np.ones((B, P), bool)

    def on(a):
        return torch.as_tensor(a, device=dev)

    tables = (on(t_costs), on(t_sizes), on(t_nc), on(t_N))

    def run_sub(idx: np.ndarray, tail: str) -> None:
        if len(idx) == 0:
            return
        sub_nc = nc_of[idx]
        k_max = int(k_of[idx].max(initial=0))
        surv = max(1, P - k_max)
        R_max = _bucket(int(-(-int(sub_nc.max()) // surv)) + 2)
        T_max = _bucket(4 * P + 16 * k_max + 64) if tail == "txn" else 0
        res = _batch(on(tech_of[idx]), on(rdlb[idx]), on(fail[idx]),
                     on(h[idx]), on(lat[idx]), on(speed[idx]), *tables,
                     P=P, R_max=R_max, T_max=T_max, tail=tail)
        (t_par, hung, valid, nleft, n_assign, n_dups, wasted,
         tasks, busy, last_done, alv) = (x.cpu().numpy() for x in res)
        out["t_par"][idx] = t_par
        out["hung"][idx] = hung
        out["valid"][idx] = valid
        out["n_finished"][idx] = t_N[tech_of[idx]] - nleft
        out["n_assignments"][idx] = n_assign
        out["n_duplicates"][idx] = n_dups
        out["wasted_tasks"][idx] = wasted
        out["pe_busy"][idx] = busy
        out["tasks_done"][idx] = tasks
        out["last_done"][idx] = last_done
        alive[idx] = alv

    run_sub(np.flatnonzero(sorted_mask), "sorted")
    run_sub(np.flatnonzero(clean_mask & ~sorted_mask), "general")
    run_sub(np.flatnonzero(~clean_mask), "txn")

    # horizon: the engine declares a hang when the finishing event pops
    # past it — lowered runs never poll, so t_par is the only check
    horizon = np.array([lowerings[u].horizon for u in tech_of])
    over = out["valid"] & ~out["hung"] & (out["t_par"] > horizon)
    out["hung"] |= over
    out["t_par"][over] = np.inf
    # idle: same derivation as EngineStats (zeros on hang)
    ok = out["valid"] & ~out["hung"]
    end = np.minimum(out["t_par"][:, None],
                     np.where(np.isfinite(fail), fail, np.inf))
    end = np.minimum(end, np.where(np.isinf(out["t_par"][:, None]),
                                   0.0, out["t_par"][:, None]))
    idle = np.maximum(0.0, end - out["pe_busy"])
    out["pe_idle"] = np.where(ok[:, None], idle, 0.0)
    return DeviceBatchResult(**out)


def simulate_spec(spec, task_times,
                  fail_times: Optional[np.ndarray] = None,
                  device=None) -> Optional[DeviceBatchResult]:
    """Convenience wrapper: lower one spec and batch it over ``fail_times``
    draws ([D, P], inf = never) on ``device``.  Returns None when the spec
    is outside the lowered regime (callers fall back to the scalar
    engine)."""
    lo, _ = lower_run(spec, task_times)
    if lo is None:
        return None
    D = 1 if fail_times is None else len(fail_times)
    return simulate_many([lo], tech_of=np.zeros(D, np.int32),
                         fail_times=fail_times, device=device)
