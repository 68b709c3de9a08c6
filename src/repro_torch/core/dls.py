"""Dynamic loop self-scheduling (DLS) techniques.

Implements the 13 techniques of the DLS4LB library that the paper extends
(Mohammed, Cavelan, Ciorba 2019, §2.1 + Table 1):

    STATIC                          static block scheduling
    SS, FSC, mFSC, GSS, TSS,        nonadaptive dynamic
    FAC, WF, RAND
    AWF-B, AWF-C, AWF-D, AWF-E, AF  adaptive dynamic

Each technique is a *chunk-size calculator*: given the scheduler state (total
iterations N, PE count P, remaining unscheduled R, and — for the adaptive
family — per-PE performance measurements), it returns the size of the next
chunk to hand to a requesting PE.  The calculators are deliberately pure
Python (the scheduler layer of the paper is host-side control logic, not
device compute); the *work itself* runs in PyTorch (see repro_torch.apps / repro_torch.runtime).

References for the formulas:
  SS     Tang & Yew 1986            chunk = 1
  FSC    Kruskal & Weiss 1985       chunk = (sqrt(2)·N·h / (σ·P·sqrt(log P)))^(2/3)
  mFSC   Banicescu et al. 2013      fixed chunk giving ≈ as many chunks as FAC
  GSS    Polychronopoulos & Kuck 87 chunk = ceil(R / P)
  TSS    Tzen & Ni 1993             linear decrease from f=ceil(N/2P) to l=1
  FAC    Hummel et al. 1992         practical variant: batch = ceil(R/2), split over P
  WF     Hummel et al. 1996         FAC batch split ∝ fixed PE weights
  RAND   Ciorba et al. 2018         chunk ~ U[N/(100P), N/(2P)]
  AWF-B/C/D/E  Carino&Banicescu 08  WF with weights re-learned per batch/chunk (±sched overhead)
  AF     Banicescu & Liu 2000       per-PE chunk from running (μ_i, σ_i) estimates
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional

import numpy as np

ALL_TECHNIQUES = (
    "STATIC", "SS", "FSC", "mFSC", "GSS", "TSS", "FAC", "WF", "RAND",
    "AWF-B", "AWF-C", "AWF-D", "AWF-E", "AF",
)
DYNAMIC_TECHNIQUES = tuple(t for t in ALL_TECHNIQUES if t != "STATIC")
ADAPTIVE_TECHNIQUES = ("AWF-B", "AWF-C", "AWF-D", "AWF-E", "AF")
NONADAPTIVE_TECHNIQUES = tuple(
    t for t in DYNAMIC_TECHNIQUES if t not in ADAPTIVE_TECHNIQUES)


@dataclasses.dataclass
class PEStats:
    """Per-PE performance measurements fed back by the scheduler.

    The adaptive techniques (AWF-*, AF) consume these; the nonadaptive ones
    ignore them.
    """
    iters_done: int = 0          # total loop iterations completed
    compute_time: float = 0.0    # total time spent computing chunks
    sched_time: float = 0.0      # total scheduling overhead attributed to PE
    # Welford running stats of the *per-iteration* time (for AF).
    n_samples: int = 0
    mean_iter_time: float = 0.0
    m2_iter_time: float = 0.0

    def record_chunk(self, size: int, compute_time: float,
                     sched_time: float) -> None:
        self.iters_done += size
        self.compute_time += compute_time
        self.sched_time += sched_time
        # Treat the chunk's mean per-iteration time as one sample (the chunk
        # is the measurement granularity the MPI library has).
        if size > 0 and compute_time >= 0:
            x = compute_time / size
            self.n_samples += 1
            d = x - self.mean_iter_time
            self.mean_iter_time += d / self.n_samples
            self.m2_iter_time += d * (x - self.mean_iter_time)

    @property
    def var_iter_time(self) -> float:
        if self.n_samples < 2:
            return 0.0
        return self.m2_iter_time / (self.n_samples - 1)

    def rate(self, include_overhead: bool) -> float:
        """Iterations/second; 0.0 when nothing measured yet."""
        t = self.compute_time + (self.sched_time if include_overhead else 0.0)
        if t <= 0.0 or self.iters_done <= 0:
            return 0.0
        return self.iters_done / t

    def scaled_copy(self, time_scale: float = 1.0) -> "PEStats":
        """Independent copy, optionally rescaling the per-iteration time.

        ``time_scale`` > 1 re-expresses the measurements in a coarsened
        task granularity (a meta-task of g original tasks runs ~g times
        longer): the mean scales by g, the variance by g**2, and the
        rate by 1/g — relative PE weights are invariant.
        """
        return PEStats(
            iters_done=self.iters_done,
            compute_time=self.compute_time * time_scale,
            sched_time=self.sched_time,
            n_samples=self.n_samples,
            mean_iter_time=self.mean_iter_time * time_scale,
            m2_iter_time=self.m2_iter_time * time_scale * time_scale,
        )


class Technique:
    """Base chunk-size calculator.

    Subclasses override ``_chunk``.  ``next_chunk`` clamps to [1, remaining].
    """

    name: str = "?"
    adaptive: bool = False

    def __init__(self, N: int, P: int, *, h: float = 1e-4,
                 sigma: float = 1.0, mu: float = 1.0,
                 weights: Optional[list[float]] = None,
                 seed: int = 0) -> None:
        if N <= 0 or P <= 0:
            raise ValueError(f"need N>0 and P>0, got N={N} P={P}")
        self.N = N
        self.P = P
        self.h = h          # scheduling overhead estimate (FSC)
        self.sigma = sigma  # iteration-time stddev estimate (FSC)
        self.mu = mu        # iteration-time mean estimate
        self.rng = random.Random(seed)
        # Fixed relative weights for WF (normalized to sum to P).
        w = weights if weights is not None else [1.0] * P
        s = sum(w)
        self.weights = [x * P / s for x in w]
        self.stats = [PEStats() for _ in range(P)]
        # FAC-family batch state.
        self._batch_left = 0
        self._batch_chunk = 0
        self._batch_index = 0
        # Adaptive techniques mirror the per-PE measurements into flat
        # numpy arrays so a chunk-size request costs one vectorized pass
        # instead of an O(P) Python loop (the array-friendly interface;
        # at P=1024 this is the difference between a sweep-friendly and
        # a sweep-hostile technique).  Rows refresh in ``record`` /
        # ``adopt_stats`` — the two in-tree mutation seams for
        # ``self.stats``; code mutating a PEStats object directly must
        # call ``refresh_stat_arrays`` afterwards.
        if self.adaptive:
            self._a_n = np.zeros(P, dtype=np.int64)   # samples per PE
            self._a_mean = np.zeros(P)                # mean iter time
            self._a_rate = np.zeros(P)                # iters/s, compute only
            self._a_rate_oh = np.zeros(P)             # iters/s incl overhead
            self._a_vm = np.zeros(P)                  # var/mean (AF's D terms)
            self._a_inv = np.zeros(P)                 # 1/mean (AF's T terms)

    # ------------------------------------------------------------------ API
    def next_chunk(self, pe: int, remaining: int) -> int:
        if remaining <= 0:
            return 0
        size = self._chunk(pe, remaining)
        return max(1, min(int(size), remaining))

    def record(self, pe: int, size: int, compute_time: float,
               sched_time: float = 0.0) -> None:
        """Feed back a completed chunk (adaptive techniques learn from it)."""
        self.stats[pe].record_chunk(size, compute_time, sched_time)
        if self.adaptive:
            self._refresh_stat_row(pe)

    def adopt_stats(self, stats: list["PEStats"],
                    time_scale: float = 1.0) -> None:
        """Pre-warm per-PE measurements from a prior technique.

        Used by mid-run technique hot-swap and by the simulator-resume
        forecaster so AWF-*/AF do not restart cold.  Copies (never
        aliases) up to ``self.P`` entries, in order.
        """
        for i in range(min(self.P, len(stats))):
            self.stats[i] = stats[i].scaled_copy(time_scale)
        self.refresh_stat_arrays()

    # ---------------------------------------------- stat-array mirror
    def _refresh_stat_row(self, pe: int) -> None:
        s = self.stats[pe]
        self._a_n[pe] = s.n_samples
        mean = s.mean_iter_time
        self._a_mean[pe] = mean
        self._a_rate[pe] = s.rate(False)
        self._a_rate_oh[pe] = s.rate(True)
        if mean > 0.0:
            self._a_vm[pe] = s.var_iter_time / mean
            self._a_inv[pe] = 1.0 / mean
        else:
            self._a_vm[pe] = 0.0
            self._a_inv[pe] = 0.0

    def refresh_stat_arrays(self) -> None:
        """Re-mirror every ``self.stats`` entry into the flat arrays
        (call after mutating PEStats objects outside record/adopt)."""
        if self.adaptive:
            for pe in range(self.P):
                self._refresh_stat_row(pe)

    # ----------------------------------------------- batched interface
    def fixed_chunk(self) -> Optional[int]:
        """The CONSTANT upcoming chunk size (pre remaining-clamp), or
        None when sizes vary.  Techniques whose every chunk is the same
        size (SS, STATIC, mFSC, FSC) advertise it here so the engine's
        vectorized fast-forward can schedule whole rounds without a
        per-chunk Python call."""
        return None

    def bulk_sizes(self, remaining: int,
                   max_chunks: int) -> Optional[np.ndarray]:
        """Sizes of the next ``k <= max_chunks`` chunks as one array, or
        None when sizes depend on the requesting PE or on feedback
        (WF with non-uniform weights, AWF-*, AF).

        Semantics are exactly ``k`` successive ``next_chunk`` calls —
        including the [1, remaining-at-that-point] clamp — and any
        internal state (TSS ramp index, FAC batch accounting, RAND rng)
        advances identically, so callers MUST consume every returned
        chunk.  Stops early when ``remaining`` runs out.
        """
        if remaining <= 0 or max_chunks <= 0:
            return np.zeros(0, dtype=np.int64)
        c = self.fixed_chunk()
        if c is None:
            return None
        c = max(1, int(c))
        n_full, tail = divmod(remaining, c)
        n = min(max_chunks, n_full + (1 if tail else 0))
        sizes = np.full(n, c, dtype=np.int64)
        if n == n_full + 1:
            sizes[-1] = tail
        return sizes

    # ------------------------------------------------------ helpers
    def _chunk(self, pe: int, remaining: int) -> int:
        raise NotImplementedError

    def _next_batch_chunk(self, remaining: int, weight: float = 1.0) -> int:
        """Practical FAC batching: batch = ceil(R/2) split equally over P.

        ``weight`` scales the equal share (WF / AWF family).
        """
        if self._batch_left <= 0:
            self._batch_left = math.ceil(remaining / 2)
            self._batch_chunk = max(1, math.ceil(self._batch_left / self.P))
            self._batch_index += 1
        size = max(1, math.ceil(self._batch_chunk * weight))
        size = min(size, self._batch_left)
        self._batch_left -= size
        return size

    def _learned_weight(self, pe: int, include_overhead: bool) -> float:
        """AWF weight: PE rate normalized so that weights sum to P.

        One vectorized pass over the stat-array mirror — O(P) numpy, no
        per-PE Python loop (identical semantics to ``PEStats.rate``).
        """
        rates = self._a_rate_oh if include_overhead else self._a_rate
        r_pe = float(rates[pe])
        if r_pe <= 0.0:
            return 1.0
        n_live = int(np.count_nonzero(rates))     # rates are never < 0
        mean_rate = float(rates.sum()) / n_live
        return r_pe / mean_rate


# ---------------------------------------------------------------- concrete
class Static(Technique):
    name = "STATIC"

    def _chunk(self, pe: int, remaining: int) -> int:
        return math.ceil(self.N / self.P)

    def fixed_chunk(self) -> Optional[int]:
        return math.ceil(self.N / self.P)


class SS(Technique):
    name = "SS"

    def _chunk(self, pe: int, remaining: int) -> int:
        return 1

    def fixed_chunk(self) -> Optional[int]:
        return 1


class FSC(Technique):
    name = "FSC"

    def _chunk(self, pe: int, remaining: int) -> int:
        return self.fixed_chunk()

    def fixed_chunk(self) -> int:
        logp = max(math.log(self.P), 1e-9)
        num = math.sqrt(2.0) * self.N * self.h
        den = max(self.sigma * self.P * math.sqrt(logp), 1e-12)
        return max(1, round((num / den) ** (2.0 / 3.0)))


def fac_chunk_count(N: int, P: int) -> int:
    """Number of chunks practical-FAC produces for (N, P)."""
    count, R = 0, N
    while R > 0:
        batch = math.ceil(R / 2)
        chunk = max(1, math.ceil(batch / P))
        n_full = batch // chunk
        count += n_full + (1 if batch % chunk else 0)
        R -= batch
    return count


class MFSC(Technique):
    name = "mFSC"

    def __init__(self, N: int, P: int, **kw) -> None:
        super().__init__(N, P, **kw)
        self._size = max(1, math.ceil(N / fac_chunk_count(N, P)))

    def _chunk(self, pe: int, remaining: int) -> int:
        return self._size

    def fixed_chunk(self) -> int:
        return self._size


class GSS(Technique):
    name = "GSS"

    def _chunk(self, pe: int, remaining: int) -> int:
        return math.ceil(remaining / self.P)

    def bulk_sizes(self, remaining: int,
                   max_chunks: int) -> Optional[np.ndarray]:
        # deterministic recurrence R -> R - ceil(R/P): one scalar step
        # per CHUNK (not per task), geometric decay
        out, R = [], remaining
        while R > 0 and len(out) < max_chunks:
            size = math.ceil(R / self.P)
            out.append(size)
            R -= size
        return np.asarray(out, dtype=np.int64)


class TSS(Technique):
    name = "TSS"

    def __init__(self, N: int, P: int, **kw) -> None:
        super().__init__(N, P, **kw)
        self.f = math.ceil(N / (2 * P))   # first chunk
        self.l = 1                         # last chunk
        n_chunks = max(1, math.ceil(2 * N / (self.f + self.l)))
        self.delta = (self.f - self.l) / max(1, n_chunks - 1)
        self._i = 0

    def _chunk(self, pe: int, remaining: int) -> int:
        size = max(1, round(self.f - self._i * self.delta))
        self._i += 1
        return size

    def bulk_sizes(self, remaining: int,
                   max_chunks: int) -> Optional[np.ndarray]:
        # linear ramp is closed-form in the chunk index; replicate the
        # per-call round + [1, remaining] clamp cumulatively
        if remaining <= 0 or max_chunks <= 0:
            return np.zeros(0, dtype=np.int64)
        idx = self._i + np.arange(max_chunks, dtype=np.int64)
        raw = np.rint(self.f - idx * self.delta).astype(np.int64)
        np.maximum(raw, 1, out=raw)
        cum = np.cumsum(raw)
        cut = int(np.searchsorted(cum, remaining))
        if cut < len(raw):                     # remaining runs out here
            sizes = raw[:cut + 1].copy()
            sizes[cut] = remaining - (int(cum[cut - 1]) if cut else 0)
        else:
            sizes = raw
        self._i += len(sizes)
        return sizes


def _bulk_batch_sizes(tech: "Technique", remaining: int,
                      max_chunks: int) -> np.ndarray:
    """Vectorized unit-weight ``_next_batch_chunk`` sequence: whole
    batches at a time (sizes within a batch are constant except the
    final partial chunk), advancing the technique's batch state exactly
    as ``max_chunks`` sequential calls would."""
    parts, emitted, R = [], 0, remaining
    while R > 0 and emitted < max_chunks:
        if tech._batch_left <= 0:
            tech._batch_left = math.ceil(R / 2)
            tech._batch_chunk = max(1, math.ceil(tech._batch_left / tech.P))
            tech._batch_index += 1
        c = tech._batch_chunk
        n_full, tail = divmod(tech._batch_left, c)
        n = min(max_chunks - emitted, n_full + (1 if tail else 0))
        sizes = np.full(n, c, dtype=np.int64)
        if n == n_full + 1:
            sizes[-1] = tail
        granted = int(sizes.sum())
        tech._batch_left -= granted
        R -= granted
        emitted += n
        parts.append(sizes)
    return (np.concatenate(parts) if parts
            else np.zeros(0, dtype=np.int64))


class FAC(Technique):
    name = "FAC"

    def _chunk(self, pe: int, remaining: int) -> int:
        return self._next_batch_chunk(remaining)

    def bulk_sizes(self, remaining: int,
                   max_chunks: int) -> Optional[np.ndarray]:
        return _bulk_batch_sizes(self, remaining, max_chunks)


class WF(Technique):
    name = "WF"

    def _chunk(self, pe: int, remaining: int) -> int:
        return self._next_batch_chunk(remaining, self.weights[pe])

    def bulk_sizes(self, remaining: int,
                   max_chunks: int) -> Optional[np.ndarray]:
        if any(w != 1.0 for w in self.weights):
            return None                # sizes depend on the requesting PE
        return _bulk_batch_sizes(self, remaining, max_chunks)


class Rand(Technique):
    name = "RAND"

    def _chunk(self, pe: int, remaining: int) -> int:
        lo = max(1, math.floor(self.N / (100 * self.P)))
        hi = max(lo, math.ceil(self.N / (2 * self.P)))
        return self.rng.randint(lo, hi)

    def bulk_sizes(self, remaining: int,
                   max_chunks: int) -> Optional[np.ndarray]:
        # the rng sequence is deterministic and PE-independent; one rng
        # draw per CHUNK (chunks are ~N/(100P) tasks or larger)
        lo = max(1, math.floor(self.N / (100 * self.P)))
        hi = max(lo, math.ceil(self.N / (2 * self.P)))
        out, R = [], remaining
        while R > 0 and len(out) < max_chunks:
            size = min(self.rng.randint(lo, hi), R)
            out.append(size)
            R -= size
        return np.asarray(out, dtype=np.int64)


class AWF(Technique):
    """AWF-B/C/D/E: weighted factoring with learned weights.

    B: weights updated per *batch*, compute time only.
    C: weights updated per *chunk*, compute time only.
    D: per batch, compute + scheduling overhead.
    E: per chunk, compute + scheduling overhead.

    With the chunk-granularity measurement model used here, "per chunk"
    updates see the freshest stats at every request, while "per batch"
    variants re-evaluate weights only at batch boundaries.
    """
    adaptive = True

    def __init__(self, N: int, P: int, variant: str = "B", **kw) -> None:
        super().__init__(N, P, **kw)
        if variant not in ("B", "C", "D", "E"):
            raise ValueError(f"bad AWF variant {variant!r}")
        self.variant = variant
        self.name = f"AWF-{variant}"
        self._cached_weights = [1.0] * P

    @property
    def barrier_per_batch(self) -> bool:
        """Batch-granularity variants (B/D) recompute RELATIVE weights
        from every PE's measurements: the master cannot compose the next
        batch until all chunks of the previous batch are reported.  This
        is the mechanism behind the paper's catastrophic AWF degradation
        under latency perturbations without rDLB — and behind rDLB's
        large flexibility boost (duplicate reports satisfy the barrier)."""
        return self.variant in ("B", "D")

    def _chunk(self, pe: int, remaining: int) -> int:
        include_oh = self.variant in ("D", "E")
        per_chunk = self.variant in ("C", "E")
        at_batch_boundary = self._batch_left <= 0
        if per_chunk or at_batch_boundary:
            self._cached_weights[pe] = self._learned_weight(pe, include_oh)
        return self._next_batch_chunk(remaining, self._cached_weights[pe])


class AF(Technique):
    """Adaptive Factoring (Banicescu & Liu 2000).

    chunk_i = (D + 2T − sqrt(D² + 4·D·T)) / (2·μ_i) with
      D = Σ_j σ_j²/μ_j   (time)
      T = R / Σ_j 1/μ_j  (time estimate of remaining work under all PEs)

    Until a PE has ≥2 measurements it falls back to the FAC batch rule
    (the library needs a bootstrap chunk to measure anything).
    """
    name = "AF"
    adaptive = True

    def _chunk(self, pe: int, remaining: int) -> int:
        # D and T come from per-PE contribution arrays maintained
        # incrementally in record() — two vectorized sums per request,
        # no O(P) Python loop
        mu_pe = float(self._a_mean[pe])
        if self._a_n[pe] < 2 or mu_pe <= 0.0:
            return self._next_batch_chunk(remaining)
        D = float(self._a_vm.sum())
        inv = float(self._a_inv.sum())
        T = remaining / max(inv, 1e-12)
        c = (D + 2.0 * T - math.sqrt(D * D + 4.0 * D * T)) / (2.0 * mu_pe)
        return max(1, math.floor(c))


_FACTORY = {
    "STATIC": Static,
    "SS": SS,
    "FSC": FSC,
    "mFSC": MFSC,
    "GSS": GSS,
    "TSS": TSS,
    "FAC": FAC,
    "WF": WF,
    "RAND": Rand,
    "AF": AF,
}


def make_technique(name: str, N: int, P: int, **kw) -> Technique:
    """Factory: ``make_technique("AWF-B", N, P)`` etc."""
    if name.startswith("AWF-"):
        return AWF(N, P, variant=name.split("-", 1)[1], **kw)
    if name not in _FACTORY:
        raise ValueError(f"unknown DLS technique {name!r}; "
                         f"choose from {ALL_TECHNIQUES}")
    return _FACTORY[name](N, P, **kw)
