"""rDLB serving executor: robust continuous batching, on the card.

Port of ``repro.runtime.serve_executor``.  Tasks = inference REQUESTS
(prompt -> generate k tokens).  Workers are model replicas.  The unified
engine (``repro_torch.core.engine``) schedules requests through the
RobustQueue; with rDLB, once every request is assigned, idle replicas
DUPLICATE in-flight requests of stragglers/failed replicas — first
completion wins (greedy decode is deterministic, and the kernels sum in
a fixed order, so duplicates give the same tokens bit for bit).

  * BATCHED DECODE: a chunk's requests are grouped by (prompt length,
    max_new_tokens) and each group decodes as ONE padded batch, the batch
    padded up to a power of two.
  * DEVICE-RESIDENT GENERATION: :class:`FusedGenerator` prefills a cache
    preallocated for the group in one full-sequence pass, then runs
    max_new steps of decode_step + greedy argmax on the device with the
    token fed straight back; the tokens reach the host once, at the end
    of the group.
  * THREADED MODE: replicas run as OS threads; rDLB duplicates race their
    originals in wall-clock time.

Process mode (``repro.cluster``) is not ported yet: ROADMAP.md queue A,
item A8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.models.common import first_tensor
from repro_torch.runtime.backends import ServeBackend


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
         full-sequence pass;
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
            logits, cache = model.prefill(params, cache, tokens)
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


def decode_request_groups(generator: FusedGenerator, params,
                          reqs: list) -> dict:
    """Decode a chunk of requests -> {rid: tokens}.

    Requests are grouped by (prompt_len, max_new_tokens); each group is
    one padded batch through the device-resident ``generator``, and
    singleton shapes fall out naturally."""
    groups: dict[tuple, list] = {}
    for r in reqs:
        groups.setdefault((len(r.prompt), r.max_new_tokens), []).append(r)
    out: dict[int, np.ndarray] = {}
    for (_, max_new), rs in groups.items():
        prompts = np.stack([r.prompt for r in rs]).astype(np.int32)
        for r, t in zip(rs, generator(params, prompts, max_new)):
            out[r.rid] = t
    return out


class RDLBServeExecutor:
    """Robust continuous batching, configured by a declarative
    :class:`repro_torch.api.RunSpec` (``spec=``, default
    ``api.serve_spec()``).

    The spec's cluster is the one perturbation vocabulary: declare dead
    replicas (``alive=False``), stragglers (``sleep_per_task`` /
    ``speed``) or count-based fail-stops (``fail_after_tasks``) there, or
    pass ``fail_at`` to :meth:`serve`.  A replica that fail-stops stays
    dead for later ``serve`` calls.  The model runs where its ``params``
    lie.  ``adaptive`` is an optional live adaptive policy object
    (``repro_torch.adaptive.AdaptiveController``; requests are unit-cost
    tasks), overriding ``spec.adaptive``.  The reference's legacy
    keywords (``n_workers=``, …) are not taken.
    """

    def __init__(self, model, params, *, spec: Optional[api.RunSpec] = None,
                 adaptive: Optional[Any] = None):
        self.spec = spec if spec is not None else api.serve_spec()
        self.model = model
        self.params = params
        self.adaptive = adaptive
        self._generator = FusedGenerator(model)
        self.dead: set[int] = {wid for wid, w in
                               enumerate(self.spec.cluster.worker_specs())
                               if not w.alive}

    def _generate_chunk(self, reqs: list[Request]) -> dict:
        """Decode a chunk of requests -> {rid: tokens}."""
        return decode_request_groups(self._generator, self.params, reqs)

    def serve(self, requests: list[Request], *,
              fail_at: Optional[dict] = None) -> ServeStats:
        """Process a batch of requests; fail_at: {wid: after_n_requests}."""
        N = len(requests)
        spec = self.spec
        if spec.execution.mode == "process":
            raise NotImplementedError(
                "serving with mode='process' (repro.cluster) is not ported "
                "to repro_torch yet: ROADMAP.md queue A, item A8")
        cluster = spec.cluster.with_serve_state(dead=self.dead,
                                                fail_at=fail_at or {})
        spec = spec.replace(cluster=cluster, n_tasks=N)
        backend = ServeBackend(requests, self._generate_chunk)
        eng = api.build(spec, backend, n_tasks=N, adaptive=self.adaptive)
        stats = api.run(spec, eng)
        for ew in eng.workers:              # fail-stops persist
            if not ew.alive:
                self.dead.add(ew.wid)
        queue = eng.queue
        return ServeStats(N, queue.n_duplicates, queue.wasted_tasks,
                          stats.hung, dict(stats.by_worker))
