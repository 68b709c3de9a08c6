"""rDLB serving executor: robust continuous batching, on the card.

Port of ``repro.runtime.serve_executor``.  Tasks = inference REQUESTS
(prompt -> generate k tokens).  Workers are model replicas.  The unified
engine (``repro_torch.core.engine``) schedules requests through the
RobustQueue; with rDLB, once every request is assigned, idle replicas
DUPLICATE in-flight requests of stragglers/failed replicas — first
completion wins (greedy decode is deterministic, and the kernels sum in
a fixed order, so duplicates give the same tokens bit for bit).

  * BATCHED DECODE (``batch_decode=True``, the default): a chunk's
    requests are grouped by (prompt length, max_new_tokens) and each
    group decodes as ONE padded batch, the batch padded up to a power of
    two; ``batch_decode=False`` decodes each request alone (the
    per-request baseline).
  * DEVICE-RESIDENT GENERATION (``fused_decode=True``, the default):
    :class:`FusedGenerator` prefills a cache preallocated for the group
    in one full-sequence pass, then runs max_new steps of decode_step +
    greedy argmax on the device with the token fed straight back; the
    tokens reach the host once, at the end of the group.  On the card a
    dense GQA model's group replays a CUDA graph of its decode step
    (:meth:`FusedGenerator.graphed`), kept with its cache on a side
    stream across groups of one (rows, cache capacity), so a group
    captures only where no such graph is kept.  A model whose prefill
    may run in segments (an O(1) carried state: rwkv6) prefills on the
    card as a chain of fixed-length segments, each replayed from a CUDA
    graph its lane keeps (:meth:`FusedGenerator.segmented`).
    ``fused_decode=False``
    walks every position, prompt included, through ``decode_step`` with
    the argmax on the host (:func:`greedy_decode_group`, the per-token
    baseline).
  * THREADED MODE: replicas run as OS threads; rDLB duplicates race their
    originals in wall-clock time.
  * PROCESS MODE: replicas are worker processes
    (``repro_torch.cluster.ServeTaskRunner``), each rebuilding the model
    from its config and the shipped weights and decoding through the same
    :func:`decode_request_groups` with the executor's two flags, so
    tokens are identical across modes.
  * SPANS: inside a traced threaded run (``ExecutionSpec.trace``) the
    engine makes the replica's chunk the thread's
    :func:`repro_torch.core.trace.current` context, and each request
    group, prefill, decode step and graph capture or kept-graph hit lands
    on the engine's flight recorder as an EV_GROUP / EV_PREFILL / EV_STEP
    / EV_GRAPH row with its wall and thread CPU time (a segmented
    prefill's captures and hits as EV_GRAPH rows "prefill-capture" /
    "prefill-hit"); no span synchronises with the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import trace
from repro_torch.kernels import dispatch
from repro_torch.models.common import first_tensor
from repro_torch.runtime.backends import ServeBackend

_UNSET = object()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 8
    output: Optional[np.ndarray] = None
    completed_by: Optional[int] = None
    duplicated: bool = False


@dataclasses.dataclass
class ServeStats:
    n_requests: int
    n_duplicates: int
    wasted_requests: int
    hung: bool
    by_worker: dict


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _padded(prompts: np.ndarray) -> np.ndarray:
    """(B, S) prompts -> (pow2 >= B, S); pad rows replicate row 0."""
    B, S = prompts.shape
    buf = np.empty((_pad_pow2(B), S), dtype=np.int32)
    buf[:B] = prompts
    buf[B:] = prompts[0]
    return buf


def _device(params) -> torch.device:
    return first_tensor(params).device


def greedy_decode_group(model, params, decode_step: Callable,
                        prompts: np.ndarray, max_new: int) -> np.ndarray:
    """Greedy-decode a (B, S) group of equal-length prompts one token per
    ``decode_step`` call, the argmax taken on the host: the per-token
    loop that :class:`FusedGenerator` is held against.  B is padded to a
    power of two; pad rows replicate row 0 and are discarded."""
    B, S = prompts.shape
    total = S + max_new
    dev = _device(params)
    toks = np.empty((_pad_pow2(B), total), dtype=np.int32)
    toks[:, :S] = _padded(prompts)
    with torch.inference_mode():
        cache = model.init_cache(toks.shape[0], total, device=dev)
        for pos in range(total - 1):
            tok = torch.from_numpy(toks[:, pos:pos + 1]).to(dev)
            logits, cache = decode_step(params, cache, tok, pos)
            if pos >= S - 1:
                toks[:, pos + 1] = torch.argmax(
                    logits[:, -1, :], dim=-1).cpu().numpy()
    return toks[:B, S:]


#: fewest decode steps a group needs for :class:`FusedGenerator` to
#: replay a CUDA graph of its step: a group that captures runs step 1
#: eagerly, the capture runs nothing, and the graph replays the rest
GRAPH_MIN_STEPS = 3
#: fewest slots of a graphed group's KV cache (:func:`cache_capacity`)
CAPACITY_FLOOR = 64
#: host counters (``kernels.dispatch.events``) of graphed groups that
#: replayed a graph kept from an earlier group, and of those that captured
GRAPH_HITS = "graph_hit"
GRAPH_CAPTURES = "graph_capture"
#: lengths of a segmented prefill's segments (:meth:`FusedGenerator.
#: segmented`), multiples of the wkv chunk (``kernels.rwkv6_scan.CHUNK``),
#: so the segments chunk a prompt as one pass does (:func:`prefill_segments`;
#: chosen by the device time of each length's replay, in PERF.md)
SEGMENT_LONG = 1024
SEGMENT_SHORT = 256
#: host counters (``kernels.dispatch.events``) of prefill segments that
#: replayed a graph their lane kept, and of those that ran eagerly and
#: then captured one
PREFILL_HITS = "prefill_graph_hit"
PREFILL_CAPTURES = "prefill_graph_capture"

_lanes_lock = threading.Lock()
_free_lanes: dict = {}


def prefill_segments(S: int) -> list:
    """(length, real tokens) of each segment of a segmented prefill of S
    prompt tokens: :data:`SEGMENT_LONG` while more than
    :data:`SEGMENT_SHORT` tokens remain, then :data:`SEGMENT_SHORT`; only
    the last is padded.  A replay costs a fixed ~6 ms of device time at
    rwkv6-1.6b's size, so a padded long segment beats several short
    ones."""
    out = []
    while S > 0:
        C = SEGMENT_LONG if S > SEGMENT_SHORT else SEGMENT_SHORT
        out.append((C, min(C, S)))
        S -= C
    return out


def cache_capacity(total: int) -> int:
    """KV-cache slots of a graphed group of ``total`` = S + max_new
    positions: the next power of two, at least :data:`CAPACITY_FLOOR`.
    A function of the group's shape alone, so a request meets the same
    kernel shapes, and gets the same tokens bit for bit, whichever lane
    and group serve it."""
    return max(CAPACITY_FLOOR, _pad_pow2(total))


class _Kept:
    """What a lane keeps for one (rows, capacity): the KV cache its groups
    prefill into, the static input token and device position the decode
    step reads, and, once captured, the step's graph with the launches
    counted while capturing it.

    The cache is never cleared between groups.  A written slot holds the
    position written there; a group's prefill and each of its steps write
    their slot before the step reads, and a step reads only slots holding
    a position in (pos - window, pos], which this group has written, so a
    slot left over from an earlier group never reads as valid."""

    def __init__(self, model, rows: int, capacity: int, dev: torch.device):
        self.cache = model.init_cache(rows, capacity, device=dev)
        self.tok = torch.zeros((rows, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.graph = None
        self.tally: Optional[dispatch.Tally] = None

    def replay(self) -> None:
        self.graph.replay()
        self.tally.replayed()


class _Segments:
    """What a lane keeps for the segmented prefill of one row count: the
    carried state its groups prefill into (zeroed at each group's start)
    and decode from, the static count of a segment's real tokens, and
    per segment length the static tokens and, once captured, the
    segment's graph, the launches counted while capturing it and the
    logits its replays write.  The state and the static inputs are
    allocated outside any capture, so the lane's graphs may share its
    pool; a replay's logits are read before the lane replays again."""

    def __init__(self, model, rows: int, dev: torch.device):
        self.state = model.init_cache(rows, 0, device=dev)
        self.valid = torch.zeros((), dtype=torch.int32, device=dev)
        self.tok = {C: torch.zeros((rows, C), dtype=torch.int32, device=dev)
                    for C in (SEGMENT_LONG, SEGMENT_SHORT)}
        self.graphs: dict = {}
        self.tally: dict = {}
        self.logits: dict = {}


class _Lane:
    """A side stream of one device that one group at a time replays on,
    the memory pool its captures share, and what it keeps for one
    (model, params): its :class:`_Kept` state per (rows, capacity) and
    its :class:`_Segments` per rows (under the key (``_Segments``,
    rows)), which it holds references to, so no graph outlives what it
    reads.  A group of another model or params drops the lane's state,
    and its pool with the graphs; replays of one lane never overlap, as
    its groups hold it leased."""

    def __init__(self, dev: torch.device):
        cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(device=dev) if cuda else None
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.owner: Optional[tuple] = None
        self.kept: dict = {}

    def _owned_by(self, model, params) -> bool:
        return (self.owner is not None and self.owner[0] is model
                and self.owner[1] is params)

    def holds(self, model, params, key: tuple) -> bool:
        return self._owned_by(model, params) and key in self.kept

    def state(self, model, params, key: tuple, dev: torch.device) -> _Kept:
        """The lane's state for ``key`` = (rows, capacity), made (its
        cache allocated) if the lane has none."""
        return self._keep(model, params, key, lambda: _Kept(model, *key, dev))

    def segments(self, model, params, rows: int,
                 dev: torch.device) -> _Segments:
        """The lane's segmented-prefill state for ``rows``, made if the
        lane has none."""
        return self._keep(model, params, (_Segments, rows),
                          lambda: _Segments(model, rows, dev))

    def _keep(self, model, params, key: tuple, make: Callable):
        """What the lane keeps under ``key`` for (model, params), from
        ``make()`` if it keeps nothing there."""
        if not self._owned_by(model, params):
            if self.kept and self.stream is not None:
                # nothing it frees is in use; a pool whose graphs are all
                # gone takes no capture again, so later ones get a new one
                self.stream.synchronize()
                self.pool = torch.cuda.graph_pool_handle()
            self.kept, self.owner = {}, (model, params)
        if key not in self.kept:
            self.kept[key] = make()
        return self.kept[key]


@contextlib.contextmanager
def _lane(dev: torch.device, model, params, key: tuple):
    """Lease a :class:`_Lane` of ``dev`` for the block: a free one that
    keeps state for ``key`` of (model, params) if there is one, else any
    free one, else a new one.  Lanes are kept for later blocks, so there
    are only as many as blocks that ran at once (and as many cuBLAS
    workspaces and graph pools).  The block must leave no work of its own
    pending on the lane (it ends by copying its tokens to the host)."""
    with _lanes_lock:
        free = _free_lanes.setdefault(dev, [])
        lane = next((ln for ln in reversed(free)
                     if ln.holds(model, params, key)), None)
        if lane is not None:
            free.remove(lane)
        else:
            lane = free.pop() if free else _Lane(dev)
    try:
        yield lane
    finally:
        with _lanes_lock:
            _free_lanes.setdefault(dev, []).append(lane)


@contextlib.contextmanager
def _on(lane: _Lane):
    """Run the block on the lane's stream, after the current stream's work
    so far and before its later work."""
    if lane.stream is None:
        yield
        return
    current = torch.cuda.current_stream(lane.stream.device)
    lane.stream.wait_stream(current)
    try:
        with torch.cuda.stream(lane.stream):
            yield
    finally:
        current.wait_stream(lane.stream)


def _capture(step: Callable[[], None], lane: _Lane) -> tuple:
    """Capture ``step`` into a CUDA graph on ``lane`` (its stream must be
    current) in the thread-local mode, since other threads keep launching
    meanwhile, into the lane's pool -> (graph, the launches counted while
    capturing: ``kernels.dispatch.capturing``, to add once per replay)."""
    graph = torch.cuda.CUDAGraph()
    with dispatch.capturing() as tally:
        graph.capture_begin(pool=lane.pool,
                            capture_error_mode="thread_local")
        try:
            step()
        finally:
            graph.capture_end()
    return graph, tally


def _static_step(model, params, cache: dict, tok_in: torch.Tensor,
                 pos: torch.Tensor) -> Callable[[], None]:
    """One decode step as a closure over a static input token and a
    static device position, which it advances: the step a graph
    captures."""
    def step() -> None:
        logits, _ = model.decode_step(params, cache, tok_in, pos)
        tok_in.copy_(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
        pos.add_(1)
    return step


class FusedGenerator:
    """Device-resident greedy generation: prefill, then a decode loop
    whose tokens never leave the device until the group is done.

    Per call (one request group):
      1. a cache for the padded group, for all S + max_new positions
         (a graphed group's is kept by its lane, below), which every step
         writes in place (the reference donates its cache into a jitted
         ``lax.scan``);
      2. ``model.prefill`` fills it for the S prompt positions in one
         full-sequence pass (a model without ``prefill`` — whisper —
         walks the prompt through ``decode_step`` instead);
      3. max_new - 1 steps of decode_step, the greedy argmax on the
         device, and the token fed straight back as the next input;
      4. one copy of the (B, max_new) tokens to the host.

    Token-identical to ``greedy_decode_group`` and to the reference's
    ``FusedGenerator`` on float32 configs (tests/test_torch_serve.py).

    The steps of 3. take one of two loops.  A group that is not graphed
    walks them from Python at int positions, whatever the model.  On a
    CUDA device, the group of a model that declares its decode step
    capturable (``model.decode_capturable``: every layer dense GQA) with
    at least :data:`GRAPH_MIN_STEPS` steps is graphed (:meth:`graphed`),
    its step one closure over a static input token and a static device
    position (:func:`_static_step`).  It leases a side stream
    (:class:`_Lane`) before its prefill, and the lane keeps, per (rows,
    :func:`cache_capacity` of S + max_new), the cache, the static token
    and position and the step's CUDA graph across groups.  The prefill
    fills that cache on the current stream; the steps run on the lane's
    stream.  A group whose (rows, capacity) the lane has graphed (a hit)
    writes its first token and S there and replays the graph from step
    1; otherwise (a capture) step 1 runs the closure eagerly (it builds
    the state a capture must not, such as the cuBLAS workspace of that
    stream), step 2 captures it once (through ``model.decode_step``, the
    instance's attribute, so a wrapper is captured too) into the lane's
    pool, and the graph replays steps 2 .. max_new - 1 and is kept.  The
    closure launches the kernels of the int-position loop, so the tokens
    do not change.
    Launches made while capturing are counted once per replay
    (``kernels.dispatch.capturing``); hits and captures are counted as
    ``kernels.dispatch.events`` :data:`GRAPH_HITS` and
    :data:`GRAPH_CAPTURES`.

    The prefill of 2. takes one of two forms.  On a CUDA device, a model
    that declares its prefill segmentable (``model.prefill_segmentable``:
    its decode cache is an O(1) carried state) prefills in segments
    (:meth:`segmented`): the group leases a lane, which keeps per rows
    the carried state (zeroed at the group's start; the decode steps
    then run from it) and per segment length of :func:`prefill_segments`
    the static tokens and the segment's graph, across groups.  Every
    segment runs on the lane's stream on the state the last one left,
    with its tokens and its count of real tokens (the state's
    ``"valid"``) copied to static buffers; a segment whose length the
    lane has graphed replays the graph (a hit), otherwise it runs
    ``model.prefill`` eagerly (which builds what a capture must not, as
    step 1 does above) and is then captured once through
    ``model.prefill`` into the lane's pool (the capture runs nothing)
    and kept.  Hits and captures are counted as ``kernels.dispatch.events``
    :data:`PREFILL_HITS` and :data:`PREFILL_CAPTURES`, one a segment.
    Any other prefill is one ``model.prefill`` call on the current
    stream.

    Under a chunk context (:func:`repro_torch.core.trace.current`) the
    prefill, each step of 3. (a replay included) and a capture or hit are
    recorded as spans (EV_PREFILL, EV_STEP, EV_GRAPH with detail
    "capture" or "hit"); a segmented prefill's EV_PREFILL is followed by
    an EV_GRAPH row "prefill-capture" and one "prefill-hit" where it had
    such segments, their size the segments.
    """

    def __init__(self, model):
        self.model = model

    def graphed(self, device: torch.device, steps: int) -> bool:
        """Whether a group of ``steps`` decode steps on ``device`` replays
        a CUDA graph of its step."""
        return (device.type == "cuda" and steps >= GRAPH_MIN_STEPS
                and getattr(self.model, "decode_capturable", False))

    def segmented(self, device: torch.device) -> bool:
        """Whether a group's prefill on ``device`` runs as segments
        replayed from CUDA graphs its lane keeps."""
        return (device.type == "cuda"
                and getattr(self.model, "prefill_segmentable", False))

    def __call__(self, params, prompts: np.ndarray,
                 max_new: int) -> np.ndarray:
        """prompts: (B, S) int32 -> generated tokens (B, max_new)."""
        B, S = prompts.shape
        model = self.model
        dev = _device(params)
        buf = _padded(np.asarray(prompts, dtype=np.int32))
        rows = buf.shape[0]
        graphed = self.graphed(dev, max_new - 1)
        segmented = not graphed and self.segmented(dev)
        key = ((_Segments, rows) if segmented
               else (rows, cache_capacity(S + max_new)))
        ctx = trace.current()
        mark = None
        with torch.inference_mode(), (
                _lane(dev, model, params, key) if graphed or segmented
                else contextlib.nullcontext()) as lane, (
                _on(lane) if segmented else contextlib.nullcontext()):
            if graphed:
                kept = lane.state(model, params, key, dev)
                cache = kept.cache
            elif segmented:
                segs = lane.segments(model, params, rows, dev)
                cache = segs.state
            else:
                cache = model.init_cache(rows, S + max_new, device=dev)
            tokens = torch.from_numpy(buf).to(dev)
            if ctx is not None:
                mark = ctx.now()
            if segmented:
                logits, graphs = self._prefill_segments(params, lane, segs,
                                                        tokens)
            elif hasattr(model, "prefill"):
                logits, cache = model.prefill(params, cache, tokens)
            else:
                for pos in range(S):
                    logits, cache = model.decode_step(
                        params, cache, tokens[:, pos:pos + 1], pos)
            if ctx is not None:
                mark = ctx.span(trace.EV_PREFILL, mark, rows * S)
                for detail, n in (graphs.items() if segmented else ()):
                    if n:
                        mark = ctx.span(trace.EV_GRAPH, mark, n,
                                        detail=detail)
            out = torch.empty((rows, max_new), dtype=torch.int32,
                              device=dev)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            out[:, 0] = tok
            if ctx is not None:
                mark = ctx.now()
            if graphed:
                return self._graphed_steps(params, lane, kept, tok, out, S,
                                           ctx, mark)[:B]
            for i in range(1, max_new):
                logits, cache = model.decode_step(params, cache,
                                                  tok[:, None], S + i - 1)
                tok = torch.argmax(logits[:, -1, :], dim=-1)
                out[:, i] = tok
                if ctx is not None:       # steps follow back to back
                    mark = ctx.span(trace.EV_STEP, mark, rows)
            return out.cpu().numpy()[:B]

    def _prefill_segments(self, params, lane: _Lane, segs: _Segments,
                          tokens: torch.Tensor) -> tuple:
        """The prompt ``tokens`` (rows, S) through the segments of
        :func:`prefill_segments`, on the lane's stream (current) and on
        ``segs``' state from zero: each a hit replaying the lane's graph
        of its length, or run eagerly and then captured -> (the logits of
        the prompt's last position, {"prefill-capture": captures,
        "prefill-hit": hits})."""
        model = self.model
        for t in segs.state.values():
            t.zero_()
        state = dict(segs.state, valid=segs.valid)
        done = {"prefill-capture": 0, "prefill-hit": 0}
        a = 0
        for C, n in prefill_segments(tokens.shape[1]):
            tok = segs.tok[C]
            tok[:, :n].copy_(tokens[:, a:a + n])
            segs.valid.fill_(n)
            a += n
            if C in segs.graphs:
                segs.graphs[C].replay()
                segs.tally[C].replayed()
                logits = segs.logits[C]
                done["prefill-hit"] += 1
                dispatch.count_event(PREFILL_HITS)
                continue
            logits, _ = model.prefill(params, state, tok)

            def segment(C=C, tok=tok) -> None:
                segs.logits[C], _ = model.prefill(params, state, tok)
            segs.graphs[C], segs.tally[C] = _capture(segment, lane)
            done["prefill-capture"] += 1
            dispatch.count_event(PREFILL_CAPTURES)
        return logits, done

    def _graphed_steps(self, params, lane: _Lane, kept: _Kept,
                       tok: torch.Tensor, out: torch.Tensor, S: int, ctx,
                       mark) -> np.ndarray:
        """Steps 1 .. max_new - 1 of a graphed group into ``out`` on its
        lane's stream, over the lane's kept state: replayed from step 1 if
        the state has a graph, else step 1 eager, step 2 captured (the
        capture runs nothing) and replayed from there; -> ``out`` on the
        host."""
        rows, max_new = out.shape
        with _on(lane):
            kept.tok.copy_(tok[:, None])
            kept.pos.fill_(S)
            step = _static_step(self.model, params, kept.cache, kept.tok,
                                kept.pos)
            if kept.graph is not None:
                dispatch.count_event(GRAPH_HITS)
                if ctx is not None:
                    mark = ctx.span(trace.EV_GRAPH, mark, max_new - 1,
                                    detail="hit")
            for i in range(1, max_new):
                if kept.graph is None and i == 2:
                    kept.graph, kept.tally = _capture(step, lane)
                    dispatch.count_event(GRAPH_CAPTURES)
                    if ctx is not None:
                        mark = ctx.span(trace.EV_GRAPH, mark, max_new - 2,
                                        detail="capture")
                if kept.graph is None:
                    step()
                else:
                    kept.replay()
                out[:, i] = kept.tok[:, 0]
                if ctx is not None:       # steps follow back to back
                    mark = ctx.span(trace.EV_STEP, mark, rows)
            return out.cpu().numpy()


def decode_request_groups(model, params, decode_step: Callable, reqs: list,
                          *, batch_decode: bool = True,
                          generator: Optional[FusedGenerator] = None
                          ) -> dict:
    """Decode a chunk of requests -> {rid: tokens}.

    Batched mode groups by (prompt_len, max_new_tokens) — each group is
    one padded batch call; singleton shapes fall out naturally; without
    it every request is a group of one.  With a ``generator`` a group
    decodes device-resident (:class:`FusedGenerator`); otherwise through
    the per-token :func:`greedy_decode_group` loop over ``decode_step``
    (the model's own: the cache is written in place).  Under a chunk
    context each group's decode is recorded as an EV_GROUP span."""
    if batch_decode:
        by_shape: dict[tuple, list] = {}
        for r in reqs:
            by_shape.setdefault((len(r.prompt), r.max_new_tokens),
                                []).append(r)
        groups = list(by_shape.values())
    else:
        groups = [[r] for r in reqs]
    ctx = trace.current()
    out: dict[int, np.ndarray] = {}
    for rs in groups:
        prompts = np.stack([r.prompt for r in rs]).astype(np.int32)
        max_new = rs[0].max_new_tokens
        if ctx is not None:
            ctx.rid = rs[0].rid
            mark = ctx.now()
        if generator is not None:
            toks = generator(params, prompts, max_new)
        else:
            toks = greedy_decode_group(model, params, decode_step, prompts,
                                       max_new)
        if ctx is not None:
            ctx.span(trace.EV_GROUP, mark, len(rs), detail=json.dumps(
                [r.rid for r in rs]) if len(rs) > 1 else None)
        for r, t in zip(rs, toks):
            out[r.rid] = t
    return out


class RDLBServeExecutor:
    """Robust continuous batching, configured by a declarative
    :class:`repro_torch.api.RunSpec` (``spec=``).

    The spec's cluster is the one perturbation vocabulary: declare dead
    replicas (``alive=False``), stragglers (``sleep_per_task`` /
    ``speed``) or count-based fail-stops (``fail_after_tasks``) there, or
    pass ``fail_at`` to :meth:`serve`; the mutable ``dead`` set (also
    :meth:`fail_worker`) and ``slow`` map (wid -> extra seconds a
    request) overlay every later ``serve``.  A replica that fail-stops
    stays dead for later ``serve`` calls.  The model runs where its
    ``params`` lie.  ``adaptive`` is an optional live adaptive policy
    object (``repro_torch.adaptive.AdaptiveController``; requests are
    unit-cost tasks), overriding ``spec.adaptive``.

    The reference's legacy keywords (``n_workers``, ``technique``,
    ``rdlb_enabled``, ``max_duplicates``, ``concurrent``) still build a
    spec through ``api.serve_spec`` (SS, 2 workers, rDLB on, threaded
    when ``concurrent``) with a ``DeprecationWarning``; mixed with
    ``spec=`` they raise ``TypeError``.
    """

    def __init__(self, model, params, *, spec: Optional[api.RunSpec] = None,
                 n_workers: Any = _UNSET,
                 technique: Any = _UNSET, rdlb_enabled: Any = _UNSET,
                 max_duplicates: Any = _UNSET,
                 batch_decode: bool = True,
                 fused_decode: bool = True,
                 concurrent: Any = _UNSET,
                 adaptive: Optional[Any] = None):
        legacy = {k: v for k, v in dict(
            n_workers=n_workers, technique=technique,
            rdlb_enabled=rdlb_enabled, max_duplicates=max_duplicates,
            concurrent=concurrent).items() if v is not _UNSET}
        if spec is None:
            if legacy:
                api.warn_legacy(f"RDLBServeExecutor({', '.join(legacy)})")
            spec = api.serve_spec(
                technique=legacy.get("technique", "SS"),
                n_workers=legacy.get("n_workers", 2),
                rdlb_enabled=legacy.get("rdlb_enabled", True),
                max_duplicates=legacy.get("max_duplicates"),
                threaded=bool(legacy.get("concurrent")))
        elif legacy:
            raise TypeError("pass spec= OR legacy keywords, not both: "
                            f"{sorted(legacy)}")
        self.spec = spec
        self.model = model
        self.params = params
        self.n_workers = spec.cluster.n_workers
        self.batch_decode = batch_decode
        self.fused_decode = fused_decode
        self.adaptive = adaptive
        self._fused = FusedGenerator(model) if fused_decode else None
        # Live perturbation state, overlaid on the spec's cluster each
        # serve(); spec-declared deaths seed the set so fail-stops persist
        self.dead: set[int] = {wid for wid, w in
                               enumerate(spec.cluster.worker_specs())
                               if not w.alive}
        self.slow: dict[int, float] = {}      # wid -> extra s per request

    def fail_worker(self, wid: int) -> None:
        self.dead.add(wid)

    def _generate(self, req: Request) -> np.ndarray:
        """Greedy decode of one request through the per-token loop (the
        pre-batching path, kept as the baseline)."""
        return greedy_decode_group(self.model, self.params,
                                   self.model.decode_step,
                                   req.prompt[None, :],
                                   req.max_new_tokens)[0]

    def _generate_chunk(self, reqs: list[Request]) -> dict:
        """Decode a chunk of requests -> {rid: tokens}."""
        return decode_request_groups(self.model, self.params,
                                     self.model.decode_step, reqs,
                                     batch_decode=self.batch_decode,
                                     generator=self._fused)

    def serve(self, requests: list[Request], *,
              fail_at: Optional[dict] = None,
              max_rounds: Optional[int] = None,
              concurrent: Optional[bool] = None) -> ServeStats:
        """Process a batch of requests; fail_at: {wid: after_n_requests};
        ``max_rounds`` bounds the virtual-time horizon; ``concurrent``
        runs this call threaded (True) or in virtual time (False)."""
        N = len(requests)
        spec = self.spec
        if concurrent is not None:
            spec = spec.override("execution.mode",
                                 "threaded" if concurrent else "virtual")
        # dead/slow/fail_at overlay onto the spec cluster: slow (extra
        # seconds per request) is a real sleep in threaded mode and a
        # speed divisor in virtual time; process mode realises both
        # fields physically, so there it is carried by sleep_per_task
        # alone (speed_compose=False), never counted twice
        process = spec.execution.mode == "process"
        cluster = spec.cluster.with_serve_state(
            dead=self.dead, slow=self.slow, fail_at=fail_at or {},
            speed_compose=not process)
        spec = spec.replace(cluster=cluster, n_tasks=N)
        if max_rounds is not None:
            spec = spec.override("execution.horizon", float(max_rounds))
        backend = ServeBackend(requests, self._generate_chunk)
        factory = None
        if process:
            # replicas as worker processes: ship the decode recipe (config,
            # host weights, request triples); each child rebuilds the
            # model and decodes through decode_request_groups
            from repro_torch.cluster import ServeTaskRunner  # lazy import
            factory = ServeTaskRunner.from_model(
                self.model, self.params, requests,
                batch_decode=self.batch_decode,
                fused_decode=self.fused_decode)
        eng = api.build(spec, backend, n_tasks=N, adaptive=self.adaptive,
                        factory=factory)
        stats = api.run(spec, eng)
        for ew in eng.workers:              # fail-stops persist
            if not ew.alive:
                self.dead.add(ew.wid)
        queue = eng.queue
        return ServeStats(N, queue.n_duplicates, queue.wasted_tasks,
                          stats.hung, dict(stats.by_worker))
