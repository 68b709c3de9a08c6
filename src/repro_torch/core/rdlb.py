"""rDLB: the paper's core contribution — a robust central work queue.

Every task (loop iteration / grad-accum chunk / serving request) carries a
flag:

    UNSCHEDULED --assign--> SCHEDULED --report--> FINISHED

Ordinary (non-robust) DLS stops assigning once every task is SCHEDULED; if a
PE then fails or straggles, its in-flight tasks never finish and the whole
execution hangs (paper Fig. 1b).  rDLB keeps assigning: once UNSCHEDULED is
exhausted, idle PEs receive *duplicates* of SCHEDULED-but-unfinished tasks,
oldest assignment first.  The first completion wins; late duplicates are
discarded idempotently.  No failure or perturbation detection is needed —
the duplicate work rides on end-of-loop idle time (paper §3).

The queue is ARRAY-NATIVE: task flags, task→owner, per-chunk unfinished
counts and duplicate counts are numpy arrays; assignment marks a chunk
with two slice writes, a report is one masked slice transaction, and the
rDLB re-issue scan is one vectorized O(live-chunks) pass — so the
per-transaction cost is independent of chunk size and million-task runs
stay cheap.  The queue also OWNS the assignment log (parallel arrays,
``seq`` = row index, materialized lazily through :class:`ChunkLog`), so
drivers never build per-chunk Python objects they don't touch.

The original pure-Python implementation is preserved verbatim as
``repro.core.refqueue.ReferenceQueue`` (JAX package) — the parity oracle: for every
technique × scenario the two produce identical assignment logs and
completion sets (tests/test_fastcore.py).

Both the discrete-event simulator (repro_torch.core.simulator) and the real
executors (repro_torch.runtime) drive this exact class, so simulated and
executed schedules cannot diverge.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core import dls


class Flag(enum.IntEnum):
    UNSCHEDULED = 0
    SCHEDULED = 1
    FINISHED = 2


# plain ints for the hot transaction paths (IntEnum attribute access is
# a surprisingly large fraction of a small-chunk report otherwise)
_SCHEDULED = int(Flag.SCHEDULED)
_FINISHED = int(Flag.FINISHED)


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A contiguous range of task ids [start, start+size) handed to a PE."""
    start: int
    size: int
    pe: int                 # PE the assignment was made to
    seq: int                # global assignment sequence number
    duplicate: bool = False  # True iff this is an rDLB re-assignment
    origin_seq: int = -1     # seq of the ORIGINAL chunk this duplicates
                             # (== seq for originals)

    def __post_init__(self):
        if self.origin_seq < 0:
            object.__setattr__(self, "origin_seq", self.seq)

    @property
    def stop(self) -> int:
        return self.start + self.size

    def tasks(self) -> range:
        return range(self.start, self.stop)


class ChunkLog(Sequence):
    """Lazy, array-backed assignment log (seq order by construction).

    Materializes :class:`Chunk` objects only on item access, so a
    million-assignment run never pays for a million dataclasses unless
    something actually walks the log.  Compares equal to any sequence of
    Chunks with the same contents.
    """

    __slots__ = ("_start", "_size", "_pe", "_origin")

    def __init__(self, start: np.ndarray, size: np.ndarray,
                 pe: np.ndarray, origin: np.ndarray) -> None:
        self._start = start
        self._size = size
        self._pe = pe
        self._origin = origin

    def __len__(self) -> int:
        return len(self._start)

    def _make(self, i: int) -> Chunk:
        seq = i if i >= 0 else len(self) + i
        origin = int(self._origin[seq])
        return Chunk(int(self._start[seq]), int(self._size[seq]),
                     int(self._pe[seq]), seq,
                     duplicate=origin != seq, origin_seq=origin)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._make(j) for j in range(*i.indices(len(self)))]
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        return self._make(i)

    def __iter__(self) -> Iterator[Chunk]:
        return (self._make(i) for i in range(len(self)))

    def __eq__(self, other) -> bool:
        if isinstance(other, ChunkLog):
            return (len(self) == len(other)
                    and bool(np.array_equal(self._start, other._start))
                    and bool(np.array_equal(self._size, other._size))
                    and bool(np.array_equal(self._pe, other._pe))
                    and bool(np.array_equal(self._origin, other._origin)))
        try:
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        except TypeError:
            return NotImplemented

    def __repr__(self) -> str:
        return f"ChunkLog(n={len(self)})"


_GROW0 = 256


class RobustQueue:
    """Central work queue implementing DLS + rDLB (array-native core).

    Parameters
    ----------
    N:            total number of tasks.
    technique:    a ``repro_torch.core.dls.Technique`` (owns chunk sizing).
    rdlb_enabled: if False, behaves like the non-robust DLS4LB — returns
                  ``None`` from ``request`` once everything is scheduled,
                  even if unfinished work remains (the paper's hang).
    max_duplicates: cap on concurrent duplicates per original chunk
                  (the paper uses unbounded; we default to P-1-equivalent
                  "unbounded" but expose the knob for the executor).
    """

    #: the engine's vectorized fast-forward understands this class's
    #: internals (repro_torch.core.fastpath); the oracle sets this False
    supports_fast_forward = True

    def __init__(self, N: int, technique: dls.Technique, *,
                 rdlb_enabled: bool = True,
                 max_duplicates: Optional[int] = None,
                 barrier_max_duplicates: Optional[int] = 1) -> None:
        self.N = N
        self.technique = technique
        self.rdlb_enabled = rdlb_enabled
        self.max_duplicates = max_duplicates
        # During a BATCH-WEIGHT BARRIER (AWF-B/D), re-issue is capped to 1
        # live duplicate per chunk AND only granted on a SUSTAINED stall
        # (a PE's second consecutive barrier miss): under high task-time
        # variance an eager duplicate of a huge chunk would otherwise
        # occupy a healthy PE that real (unscheduled) work will need as
        # soon as the barrier clears — a beyond-paper finding
        # (EXPERIMENTS §Paper-validation).
        self.barrier_max_duplicates = barrier_max_duplicates
        # pe -> consecutive barrier misses.  The cap is DAMPING, not a hard
        # limit: after 3 misses it is lifted, because a capped duplicate may
        # itself be held by a failed PE (which the master, by design, cannot
        # detect) — a hard cap would livelock.
        self._barrier_waiters: dict[int, int] = {}
        self.flags = np.zeros(N, dtype=np.uint8)   # Flag per task
        self._next_unscheduled = 0       # frontier: all before is scheduled
        self._n_finished = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._task_owner = np.full(N, -1, dtype=np.int64)
        # Assignment log + per-chunk accounting, parallel arrays indexed
        # by seq (amortized growth).  ``_c_left`` counts unfinished tasks
        # of ORIGINAL chunks (0 for duplicates); ``_c_dups`` counts live
        # duplicates per original.
        cap = _GROW0
        self._c_start = np.zeros(cap, dtype=np.int64)
        self._c_size = np.zeros(cap, dtype=np.int64)
        self._c_pe = np.zeros(cap, dtype=np.int64)
        self._c_origin = np.zeros(cap, dtype=np.int64)
        self._c_left = np.zeros(cap, dtype=np.int64)
        self._c_dups = np.zeros(cap, dtype=np.int64)
        # rDLB re-issue ring: seqs of original chunks not yet known
        # finished, oldest first, with a rotating pointer.  Compaction is
        # eager-on-scan (equivalent cyclic order to the oracle's lazy
        # per-entry removal; the pointer is remapped on compaction).
        self._ring = np.zeros(cap, dtype=np.int64)
        self._ring_n = 0
        self._reissue_ptr = 0
        # bookkeeping for metrics
        self.n_assignments = 0
        self.n_duplicates = 0
        self.wasted_tasks = 0                  # duplicate executions discarded
        self.wait_hint = None                  # set by request(): "barrier"?

    # ------------------------------------------------------------- queries
    @property
    def all_scheduled(self) -> bool:
        return self._next_unscheduled >= self.N

    @property
    def done(self) -> bool:
        return self._n_finished >= self.N

    @property
    def n_finished(self) -> int:
        return self._n_finished

    def flags_view(self) -> np.ndarray:
        """The live task-flag array (uint8 of :class:`Flag` values).

        A VIEW, not a copy: cheap to consult at any scale, but callers
        must treat it as read-only and racy unless they hold a
        consistent copy from :meth:`snapshot_state`.
        """
        return self.flags

    def unfinished_ids(self) -> np.ndarray:
        """Ids of every task not yet FINISHED, ascending (O(N) numpy —
        one ``np.flatnonzero`` pass, no Python list materialization)."""
        return np.flatnonzero(self.flags != Flag.FINISHED)

    def unfinished_tasks(self) -> list[int]:
        """Back-compat wrapper over :meth:`unfinished_ids` (list copy).
        Prefer the array form for anything large."""
        return self.unfinished_ids().tolist()

    def chunk_log(self) -> ChunkLog:
        """The full assignment log, seq order, as a lazy array view."""
        n = self._seq
        return ChunkLog(self._c_start[:n].copy(), self._c_size[:n].copy(),
                        self._c_pe[:n].copy(), self._c_origin[:n].copy())

    def chunk_at(self, seq: int) -> Chunk:
        origin = int(self._c_origin[seq])
        return Chunk(int(self._c_start[seq]), int(self._c_size[seq]),
                     int(self._c_pe[seq]), seq,
                     duplicate=origin != seq, origin_seq=origin)

    # ------------------------------------------------------------ protocol
    @property
    def at_batch_barrier(self) -> bool:
        """True when the technique cannot size the next chunk yet: an
        adaptive batch-granularity technique (AWF-B/D) is at a batch
        boundary with unfinished scheduled work outstanding (it needs
        every PE's report to recompute relative weights)."""
        if not getattr(self.technique, "barrier_per_batch", False):
            return False
        if getattr(self.technique, "_batch_left", 1) > 0:
            return False
        return self._n_finished < self._next_unscheduled

    @property
    def nonrobust_dead_end(self) -> bool:
        """True when a worker can NEVER receive work again: re-issue is
        off, everything is scheduled, and no barrier will clear (the
        paper's Fig.-1b wait-forever state).  Shared by the threaded
        and process release paths so their semantics cannot drift."""
        return (not self.rdlb_enabled and self.all_scheduled
                and not self.at_batch_barrier)

    def _grow(self, need: int) -> None:
        cap = len(self._c_start)
        if need <= cap:
            return
        new = max(need, cap * 2)
        for name in ("_c_start", "_c_size", "_c_pe", "_c_origin",
                     "_c_left", "_c_dups", "_ring"):
            old = getattr(self, name)
            arr = np.zeros(new, dtype=old.dtype)
            arr[:len(old)] = old
            setattr(self, name, arr)

    def _log_chunk(self, start: int, size: int, pe: int,
                   origin: int, left: int) -> int:
        """Append one chunk row; returns its seq.  Caller holds the lock."""
        seq = self._seq
        self._grow(seq + 1)
        self._c_start[seq] = start
        self._c_size[seq] = size
        self._c_pe[seq] = pe
        self._c_origin[seq] = origin
        self._c_left[seq] = left
        self._seq = seq + 1
        self.n_assignments += 1
        return seq

    def request(self, pe: int) -> Optional[Chunk]:
        """A free PE asks for work.  Returns a Chunk or None.

        None means: nothing to hand out *right now*.  With rDLB that only
        happens when the loop is done (or every unfinished chunk is already
        duplicated up to ``max_duplicates``); without rDLB it happens as
        soon as everything is merely scheduled — or while the technique is
        stalled at a batch-weight barrier (``wait_hint`` distinguishes the
        two: a barrier clears when reports arrive; the post-scheduling wait
        never does).
        """
        with self._lock:
            self.wait_hint = None
            if self.done:
                return None
            remaining = self.N - self._next_unscheduled
            if remaining > 0:
                if self.at_batch_barrier:
                    # master is collecting weights; rDLB rides the stall
                    # by re-issuing unfinished work of the pending batch —
                    # but only once the stall is sustained (2nd miss);
                    # after the 3rd miss the duplicate cap is lifted (a
                    # capped duplicate may be on a failed PE).
                    self.wait_hint = "barrier"
                    misses = self._barrier_waiters.get(pe, 0)
                    if self.rdlb_enabled and misses >= 1:
                        cap = (self.barrier_max_duplicates
                               if misses < 3 else None)
                        dup = self._reissue(pe, max_dup=cap)
                        if dup is not None:
                            return dup
                    self._barrier_waiters[pe] = misses + 1
                    return None
                self._barrier_waiters.clear()
                size = self.technique.next_chunk(pe, remaining)
                start = self._next_unscheduled
                seq = self._log_chunk(start, size, pe, self._seq, size)
                self.flags[start:start + size] = _SCHEDULED
                self._task_owner[start:start + size] = seq
                self._next_unscheduled = start + size
                self._grow(self._ring_n + 1)
                self._ring[self._ring_n] = seq
                self._ring_n += 1
                return Chunk(start, size, pe, seq)
            if not self.rdlb_enabled:
                return None                      # non-robust: hang forever
            return self._reissue(pe)

    def _reissue(self, pe: int,
                 max_dup: Optional[int] = None) -> Optional[Chunk]:
        """rDLB: hand out the oldest SCHEDULED-but-unfinished chunk.

        One vectorized pass over the ring of live original chunks:
        finished entries are compacted out (pointer remapped to keep the
        oracle's cyclic order), then the first entry at-or-after the
        rotating pointer with a free duplicate slot wins — O(live)."""
        cap = max_dup if max_dup is not None else self.max_duplicates
        n = self._ring_n
        if n == 0:
            return None
        ring = self._ring[:n]
        live = self._c_left[ring] > 0
        if not live.all():
            before = int(np.count_nonzero(live[:self._reissue_ptr]))
            survivors = ring[live]
            n = len(survivors)
            self._ring[:n] = survivors
            self._ring_n = n
            self._reissue_ptr = before
            if n == 0:
                return None
            ring = self._ring[:n]
        ptr = self._reissue_ptr
        if ptr >= n:
            ptr = 0
        if cap is None:
            pos = ptr                  # every ring entry is live now
        else:
            # cyclic scan from ptr without materializing an order array
            dups = self._c_dups
            hits = np.flatnonzero(dups[ring[ptr:]] < cap)
            if len(hits):
                pos = ptr + int(hits[0])
            else:
                hits = np.flatnonzero(dups[ring[:ptr]] < cap)
                if len(hits) == 0:
                    # full failed scan leaves the pointer where it started
                    self._reissue_ptr = ptr
                    return None
                pos = int(hits[0])
        seq = int(ring[pos])
        self._reissue_ptr = pos + 1
        self._c_dups[seq] += 1
        dup_seq = self._log_chunk(int(self._c_start[seq]),
                                  int(self._c_size[seq]), pe, seq, 0)
        self.n_duplicates += 1
        return Chunk(int(self._c_start[seq]), int(self._c_size[seq]),
                     pe, dup_seq, duplicate=True, origin_seq=seq)

    def report(self, chunk: Chunk) -> int:
        """A PE reports a completed chunk.  Returns #tasks newly finished.

        Idempotent: tasks already FINISHED (a duplicate raced us) are
        counted as wasted work, not double-finished.
        """
        with self._lock:
            return self._report_locked(chunk)[0]

    # the engine's no-op-commit path needs only the count — the SAME
    # transaction (aliased so the two can never drift apart)
    report_count = report

    def report_tasks(self, chunk: Chunk) -> list[int]:
        """Like ``report`` but returns the NEWLY-finished task ids.

        The engine layer needs the ids (not just the count) to commit
        backend results exactly-once: a duplicate's payload is applied
        only for tasks its report won.
        """
        with self._lock:
            n_new, mask = self._report_locked(chunk, want_ids=True)
            if n_new == chunk.size:
                return list(chunk.tasks())
            if n_new == 0:
                return []
            return (np.flatnonzero(mask) + chunk.start).tolist()

    def _report_locked(self, chunk: Chunk, want_ids: bool = False):
        """One report transaction (lock held).  Returns (n_new, mask)."""
        sub = self.flags[chunk.start:chunk.stop]
        mask = sub != _FINISHED
        n_new = int(np.count_nonzero(mask))
        if n_new:
            if n_new == chunk.size:
                sub[:] = _FINISHED
            else:
                sub[mask] = _FINISHED
            # every task of a chunk shares one owning original chunk
            # (originals partition [0, N); duplicates copy an original's
            # range), so the unfinished count update is O(1)
            self._c_left[chunk.origin_seq] -= n_new
            self._n_finished += n_new
        self.wasted_tasks += chunk.size - n_new
        if chunk.duplicate and self._c_dups[chunk.origin_seq] > 0:
            # Free the duplicate slot under the ORIGINAL chunk's seq —
            # that is the key _reissue incremented.
            self._c_dups[chunk.origin_seq] -= 1
        return n_new, (mask if want_ids else None)

    # ----------------------------------------------------- adaptive support
    def snapshot_state(self) -> dict:
        """Consistent point-in-time copy of the task accounting (for the
        adaptive layer's mid-run snapshots).  Taken under the queue lock,
        so neither the flag array nor the technique's learned stats
        (mutated by ``record_feedback`` under the same lock) can be seen
        mid-update.  ``stats`` are independent per-PE copies."""
        with self._lock:
            return dict(
                flags=self.flags.tobytes(),
                n_finished=self._n_finished,
                next_unscheduled=self._next_unscheduled,
                outstanding_duplicates=int(self._c_dups[:self._seq].sum()),
                technique=self.technique.name,
                rdlb_enabled=self.rdlb_enabled,
                max_duplicates=self.max_duplicates,
                barrier_max_duplicates=self.barrier_max_duplicates,
                stats=[s.scaled_copy() for s in self.technique.stats],
            )

    _KEEP = object()          # sentinel: leave the knob unchanged

    def swap_technique(self, technique: dls.Technique, *,
                       max_duplicates: Any = _KEEP,
                       barrier_max_duplicates: Any = _KEEP,
                       rdlb_enabled: Any = _KEEP) -> None:
        """Hot-swap the chunk-size calculator (and rDLB knobs) mid-run.

        Exactly-once accounting is owned by the flag array and the
        original-chunk bookkeeping, none of which is touched: in-flight
        chunks complete (or get re-issued) exactly as before, and the new
        technique only sizes FUTURE chunks.  Barrier-miss counters reset
        because the incoming technique starts with clean batch state.
        ``rdlb_enabled`` may toggle the re-issue path itself (request()
        consults it per transaction, so enabling it mid-run immediately
        lets idle workers pick up duplicates).
        """
        with self._lock:
            self.technique = technique
            if max_duplicates is not self._KEEP:
                self.max_duplicates = max_duplicates
            if barrier_max_duplicates is not self._KEEP:
                self.barrier_max_duplicates = barrier_max_duplicates
            if rdlb_enabled is not self._KEEP:
                self.rdlb_enabled = rdlb_enabled
            self._barrier_waiters.clear()

    def record_feedback(self, chunk: Chunk, compute_time: float,
                        sched_time: float) -> None:
        """Feed a completed chunk's measurements to the technique under
        the queue lock — ``request`` mutates/reads technique state under
        the same lock, so adaptive weights never see torn updates."""
        with self._lock:
            self.technique.record(chunk.pe, chunk.size,
                                  compute_time, sched_time)

    # ------------------------------------------- fast-forward (bulk) path
    def commit_fast_forward(self, *, P: int, c: int, n_rounds: int,
                            n_reported_rounds: int) -> int:
        """Register ``n_rounds`` round-robin rounds of original chunks in
        one bulk transaction (the vectorized virtual-time fast-forward,
        repro_torch.core.fastpath).

        Round-major order, PE = chunk index mod P, every chunk exactly
        ``c`` tasks; the first ``n_reported_rounds`` rounds are marked
        FINISHED, the rest stay SCHEDULED (in flight).  Only valid on a
        fresh queue with no barrier technique.  Returns the first seq.
        """
        if n_reported_rounds > n_rounds:
            raise ValueError("cannot report more rounds than assigned")
        with self._lock:
            if self._seq != 0 or self._next_unscheduled != 0:
                raise RuntimeError("fast-forward needs a fresh queue")
            n_chunks = n_rounds * P
            n_tasks = n_chunks * c
            if n_tasks > self.N:
                raise ValueError("fast-forward window exceeds N")
            self._grow(n_chunks)
            seqs = np.arange(n_chunks, dtype=np.int64)
            self._c_start[:n_chunks] = seqs * c
            self._c_size[:n_chunks] = c
            self._c_pe[:n_chunks] = seqs % P
            self._c_origin[:n_chunks] = seqs
            self._c_left[:n_chunks] = 0
            n_done = n_reported_rounds * P * c
            self._c_left[n_reported_rounds * P:n_chunks] = c
            self.flags[:n_done] = Flag.FINISHED
            self.flags[n_done:n_tasks] = Flag.SCHEDULED
            self._task_owner[:n_tasks] = np.repeat(seqs, c)
            self._next_unscheduled = n_tasks
            self._n_finished = n_done
            self._seq = n_chunks
            self.n_assignments = n_chunks
            # ring: only the in-flight originals survive (eager form of
            # the oracle's lazy pruning; cyclic order preserved)
            n_live = n_chunks - n_reported_rounds * P
            self._ring[:n_live] = seqs[n_reported_rounds * P:]
            self._ring_n = n_live
            self._reissue_ptr = 0
            return 0

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        return dict(
            n_tasks=self.N,
            n_finished=self._n_finished,
            n_assignments=self.n_assignments,
            n_duplicates=self.n_duplicates,
            wasted_tasks=self.wasted_tasks,
        )


def run_to_completion(queue: "RobustQueue", pes: Sequence[int],
                      max_rounds: int = 10**7) -> list:
    """Drain ``queue`` with synchronous unit-cost PEs (test helper).

    A trivial backend of the unified engine (repro_torch.core.engine): chunks
    cost their size in virtual seconds and execution is a no-op.  Returns
    the assignment log.  Raises if the queue cannot finish (e.g.
    rdlb_enabled=False and a chunk is never reported).
    """
    from repro_torch.core import engine  # engine imports rdlb; import lazily
    workers = [engine.EngineWorker(pe) for pe in pes]
    eng = engine.Engine(queue, workers, engine.WorkerBackend(),
                        h=0.0, horizon=float(max_rounds))
    stats = eng.run()
    if stats.hung:
        raise RuntimeError("queue stalled (non-robust hang?)")
    return stats.assignment_log
