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
    tokens reach the host once, at the end of the group.
    ``fused_decode=False`` walks every position, prompt included, through
    ``decode_step`` with the argmax on the host
    (:func:`greedy_decode_group`, the per-token baseline).
  * THREADED MODE: replicas run as OS threads; rDLB duplicates race their
    originals in wall-clock time.
  * PROCESS MODE: replicas are worker processes
    (``repro_torch.cluster.ServeTaskRunner``), each rebuilding the model
    from its config and the shipped weights and decoding through the same
    :func:`decode_request_groups` with the executor's two flags, so
    tokens are identical across modes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import api
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


class FusedGenerator:
    """Device-resident greedy generation: prefill, then a decode loop
    whose tokens never leave the device until the group is done.

    Per call (one request group):
      1. a cache for the padded group is allocated once, for all
         S + max_new positions, and every step writes it in place (the
         reference donates its cache into a jitted ``lax.scan``);
      2. ``model.prefill`` fills it for the S prompt positions in one
         full-sequence pass (a model without ``prefill`` — whisper —
         walks the prompt through ``decode_step`` instead);
      3. max_new - 1 steps of decode_step, the greedy argmax on the
         device, and the token fed straight back as the next input;
      4. one copy of the (B, max_new) tokens to the host.

    Token-identical to ``greedy_decode_group`` and to the reference's
    ``FusedGenerator`` on float32 configs (tests/test_torch_serve.py).
    No CUDA graph yet: every step launches its kernels from Python.
    """

    def __init__(self, model):
        self.model = model

    def __call__(self, params, prompts: np.ndarray,
                 max_new: int) -> np.ndarray:
        """prompts: (B, S) int32 -> generated tokens (B, max_new)."""
        B, S = prompts.shape
        model = self.model
        dev = _device(params)
        buf = _padded(np.asarray(prompts, dtype=np.int32))
        with torch.inference_mode():
            cache = model.init_cache(buf.shape[0], S + max_new, device=dev)
            tokens = torch.from_numpy(buf).to(dev)
            if hasattr(model, "prefill"):
                logits, cache = model.prefill(params, cache, tokens)
            else:
                for pos in range(S):
                    logits, cache = model.decode_step(
                        params, cache, tokens[:, pos:pos + 1], pos)
            out = torch.empty((buf.shape[0], max_new), dtype=torch.int32,
                              device=dev)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            out[:, 0] = tok
            for i in range(1, max_new):
                logits, cache = model.decode_step(params, cache,
                                                  tok[:, None], S + i - 1)
                tok = torch.argmax(logits[:, -1, :], dim=-1)
                out[:, i] = tok
            return out.cpu().numpy()[:B]


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
    (the model's own: the cache is written in place)."""
    def decode_group(prompts: np.ndarray, max_new: int) -> np.ndarray:
        if generator is not None:
            return generator(params, prompts, max_new)
        return greedy_decode_group(model, params, decode_step, prompts,
                                   max_new)
    if not batch_decode:
        return {r.rid: decode_group(r.prompt[None, :], r.max_new_tokens)[0]
                for r in reqs}
    groups: dict[tuple, list] = {}
    for r in reqs:
        groups.setdefault((len(r.prompt), r.max_new_tokens), []).append(r)
    out: dict[int, np.ndarray] = {}
    for (_, max_new), rs in groups.items():
        prompts = np.stack([r.prompt for r in rs]).astype(np.int32)
        for r, t in zip(rs, decode_group(prompts, max_new)):
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
