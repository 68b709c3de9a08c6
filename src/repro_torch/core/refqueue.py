"""The reference rDLB queue: the original pure-Python implementation.

This is the pre-array-core ``RobustQueue`` preserved verbatim as the
PARITY ORACLE.  ``repro_torch.core.rdlb.RobustQueue`` reimplements the same
transaction semantics over numpy arrays (slice-based flag assignment,
vectorized re-issue scan, array-backed assignment log) so that
million-task runs simulate in seconds; this module keeps the simple
per-task bytearray/dict version so tests can assert, for every
technique and scenario, that the two produce IDENTICAL assignment logs
and completion sets (tests/test_fastcore.py in the reference,
tests/test_torch_copies.py for this copy).

Do not optimize this file: its value is that it is obviously correct
and never changes except to fix a semantic bug (in which case the array
core must change identically, witnessed by the parity suite).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from repro_torch.core import dls
from repro_torch.core.rdlb import Chunk, Flag


class ReferenceQueue:
    """Central work queue implementing DLS + rDLB (pure-Python oracle).

    Same constructor and transaction API as
    :class:`repro_torch.core.rdlb.RobustQueue`; see there for parameter docs.
    """

    #: the engine's fast-forward path only ever engages on the array core
    supports_fast_forward = False

    def __init__(self, N: int, technique: dls.Technique, *,
                 rdlb_enabled: bool = True,
                 max_duplicates: Optional[int] = None,
                 barrier_max_duplicates: Optional[int] = 1) -> None:
        self.N = N
        self.technique = technique
        self.rdlb_enabled = rdlb_enabled
        self.max_duplicates = max_duplicates
        self.barrier_max_duplicates = barrier_max_duplicates
        self._barrier_waiters: dict[int, int] = {}
        self.flags = bytearray(N)              # Flag per task
        self._next_unscheduled = 0             # frontier: everything before is scheduled
        self._n_finished = 0
        self._seq = 0
        self._lock = threading.Lock()
        # Original (non-duplicate) chunks in assignment order — the rDLB
        # re-issue scan walks these oldest-first (paper: "the first
        # scheduled and unfinished task is assigned").
        self._assigned: list[Chunk] = []
        self._by_seq: dict[int, Chunk] = {}
        self._task_owner = [-1] * N            # task -> original chunk seq
        self._chunk_left: dict[int, int] = {}  # seq -> unfinished tasks
        self._ring: list[int] = []             # unfinished original seqs
        self._reissue_ptr = 0
        self._dup_count: dict[int, int] = {}   # chunk.seq -> live duplicates
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

    def unfinished_tasks(self) -> list[int]:
        return [i for i in range(self.N) if self.flags[i] != Flag.FINISHED]

    # ------------------------------------------------------------ protocol
    @property
    def at_batch_barrier(self) -> bool:
        if not getattr(self.technique, "barrier_per_batch", False):
            return False
        if getattr(self.technique, "_batch_left", 1) > 0:
            return False
        return self._n_finished < self._next_unscheduled

    @property
    def nonrobust_dead_end(self) -> bool:
        return (not self.rdlb_enabled and self.all_scheduled
                and not self.at_batch_barrier)

    def request(self, pe: int) -> Optional[Chunk]:
        with self._lock:
            self.wait_hint = None
            if self.done:
                return None
            remaining = self.N - self._next_unscheduled
            if remaining > 0:
                if self.at_batch_barrier:
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
                chunk = Chunk(self._next_unscheduled, size, pe, self._seq)
                self._seq += 1
                for i in chunk.tasks():
                    self.flags[i] = Flag.SCHEDULED
                    self._task_owner[i] = chunk.seq
                self._next_unscheduled += size
                self._assigned.append(chunk)
                self._by_seq[chunk.seq] = chunk
                self._chunk_left[chunk.seq] = size
                self._ring.append(chunk.seq)
                self.n_assignments += 1
                return chunk
            if not self.rdlb_enabled:
                return None                      # non-robust: hang forever
            return self._reissue(pe)

    def _reissue(self, pe: int,
                 max_dup: Optional[int] = None) -> Optional[Chunk]:
        cap = max_dup if max_dup is not None else self.max_duplicates
        checked = 0
        while self._ring and checked < len(self._ring):
            if self._reissue_ptr >= len(self._ring):
                self._reissue_ptr = 0
            seq = self._ring[self._reissue_ptr]
            if self._chunk_left.get(seq, 0) <= 0:     # finished: drop
                self._ring.pop(self._reissue_ptr)
                continue
            checked += 1
            if cap is not None and self._dup_count.get(seq, 0) >= cap:
                self._reissue_ptr += 1
                continue
            self._reissue_ptr += 1
            cand = self._by_seq[seq]
            self._dup_count[seq] = self._dup_count.get(seq, 0) + 1
            dup = Chunk(cand.start, cand.size, pe, self._seq,
                        duplicate=True, origin_seq=seq)
            self._seq += 1
            self.n_assignments += 1
            self.n_duplicates += 1
            return dup
        return None

    def report(self, chunk: Chunk) -> int:
        return len(self.report_tasks(chunk))

    report_count = report

    def report_tasks(self, chunk: Chunk) -> list[int]:
        with self._lock:
            newly: list[int] = []
            for i in chunk.tasks():
                if self.flags[i] != Flag.FINISHED:
                    self.flags[i] = Flag.FINISHED
                    newly.append(i)
                    owner = self._task_owner[i]
                    if owner >= 0:
                        self._chunk_left[owner] -= 1
                else:
                    self.wasted_tasks += 1
            self._n_finished += len(newly)
            if chunk.duplicate:
                c = self._dup_count.get(chunk.origin_seq)
                if c:
                    self._dup_count[chunk.origin_seq] = c - 1
            return newly

    # ----------------------------------------------------- adaptive support
    def snapshot_state(self) -> dict:
        with self._lock:
            return dict(
                flags=bytes(self.flags),
                n_finished=self._n_finished,
                next_unscheduled=self._next_unscheduled,
                outstanding_duplicates=sum(
                    v for v in self._dup_count.values() if v > 0),
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
        with self._lock:
            self.technique.record(chunk.pe, chunk.size,
                                  compute_time, sched_time)

    # ------------------------------------------------------------- metrics
    # NOTE: no ``chunk_log`` here — the reference queue keeps no full
    # assignment log, so the engine falls back to its own append log
    # (sorted by seq) when driving this class.

    def stats(self) -> dict:
        return dict(
            n_tasks=self.N,
            n_finished=self._n_finished,
            n_assignments=self.n_assignments,
            n_duplicates=self.n_duplicates,
            wasted_tasks=self.wasted_tasks,
        )
