"""Worker process: the child side of the process-cluster runtime.

Port of ``repro.cluster.worker``.  ``worker_main`` is the child entry
point, reached two ways: forked directly for lightweight runners (fast;
closure-friendly), or via a fresh interpreter (``python -m
repro_torch.cluster._child``) for runners that declare ``start_method =
"spawn"`` — those use the card, and a forked child of a process that has
initialised CUDA cannot (nor may a forked child inherit the parent's
intra-op thread pool mid-use); their arguments must be picklable.  The
loop speaks exactly the engine's protocol: request -> (assign | wait |
done); execute; report; repeat.  Workers know nothing about
perturbations beyond their own injected ``sleep_per_task`` — kills,
freezes and throttles land as raw signals from the chaos layer,
undetected, exactly as the paper assumes.

A *runner* is the picklable unit of execution: a callable
``runner(task_ids) -> {task_id: payload}`` with an optional one-time
``setup()`` hook that runs in the child (heavyweight imports — torch,
model builds — belong there, not at pickle time).

Which kernels a child ran: before each report a child sends
``("kernels", wid, info)`` — its pid, ``kernels.dispatch`` status and
launch counts (counted per process, so the master's own say nothing
about its children) and its peak card memory — whenever it has loaded
the kernel package; the master keeps the latest per child
(``repro_torch.cluster.runs``).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import sys
import time
from typing import Any, Callable, Optional, Sequence

from repro_torch.cluster import transport


# ------------------------------------------------------------------ runners
@dataclasses.dataclass
class NullRunner:
    """Execution is a no-op (dry runs / pure scheduling measurements)."""

    def __call__(self, tasks: Sequence[int]) -> dict:
        return {t: None for t in tasks}


@dataclasses.dataclass
class SleepRunner:
    """Tasks are real wall-clock sleeps of their nominal durations —
    the process-mode twin of the simulator's virtual task costs (one
    virtual second = ``scale`` wall seconds)."""
    task_times: Any = None          # sequence of per-task seconds, or None
    unit: float = 1.0               # seconds per task when task_times None
    scale: float = 1.0

    def __call__(self, tasks: Sequence[int]) -> dict:
        out = {}
        for t in tasks:
            dt = (self.unit if self.task_times is None
                  else float(self.task_times[t])) * self.scale
            if dt > 0.0:
                time.sleep(dt)
            out[t] = None
        return out


def task_device(task_fn: Optional[Callable]) -> str:
    """``"cuda"`` when ``task_fn`` computes on the card, else ``"cpu"``.

    The port's compute functions take ``device=`` with ``None`` meaning
    the card; a ``functools.partial`` binds it.  So the device is the
    bound ``device`` keyword, else the function's own default for it; a
    function without a ``device`` parameter runs on the host."""
    if task_fn is None:
        return "cpu"
    fn, bound = task_fn, {}
    while isinstance(fn, functools.partial):
        bound = {**fn.keywords, **bound}
        fn = fn.func
    if "device" in bound:
        dev = bound["device"]
    else:
        try:
            param = inspect.signature(fn).parameters.get("device")
        except (TypeError, ValueError):
            param = None
        if param is None:
            return "cpu"
        dev = param.default
    if dev is None:
        return "cuda"
    return getattr(dev, "type", str(dev).split(":")[0])


@dataclasses.dataclass
class FnRunner:
    """Run a picklable ``task_fn(task_id)`` per task (the FnBackend
    twin; results are committed exactly-once by the master).

    When ``task_times`` is given, each task additionally occupies its
    NOMINAL duration in real time (sleep after compute) — so a
    process-mode run realizes the same cost model the virtual twin
    predicts, not just the same results.

    A ``task_fn`` that computes on the card (:func:`task_device`) makes
    the runner spawn fresh interpreters (``start_method``): it must be a
    module-level function, or a ``functools.partial`` of one, such as
    ``partial(apps.mandelbrot.compute_tile, device="cuda")``."""
    task_fn: Optional[Callable[[int], Any]] = None
    task_times: Any = None

    @property
    def device(self) -> str:
        return task_device(self.task_fn)

    @property
    def start_method(self) -> str:
        return "spawn" if self.device == "cuda" else "fork"

    def __call__(self, tasks: Sequence[int]) -> dict:
        out = {}
        for t in tasks:
            out[t] = None if self.task_fn is None else self.task_fn(t)
            if self.task_times is not None:
                dt = float(self.task_times[t])
                if dt > 0.0:
                    time.sleep(dt)
        return out


@dataclasses.dataclass
class ChunkRunner:
    """Run a picklable ``chunk_fn(task_ids) -> results`` once per chunk,
    ``results[i]`` belonging to ``task_ids[i]`` — for tasks that compute
    as one batch, such as ``apps.psia.compute_tasks`` (one spin-image
    launch a chunk).  It spawns when ``chunk_fn`` computes on the card,
    as :class:`FnRunner` does."""
    chunk_fn: Callable[[list], Any]

    @property
    def device(self) -> str:
        return task_device(self.chunk_fn)

    @property
    def start_method(self) -> str:
        return "spawn" if self.device == "cuda" else "fork"

    def __call__(self, tasks: Sequence[int]) -> dict:
        return dict(zip(tasks, self.chunk_fn(list(tasks))))


def kernel_info() -> Optional[dict]:
    """This process's kernel path and launch counts, and its peak card
    memory; None when it never loaded the kernel package."""
    dispatch = sys.modules.get("repro_torch.kernels.dispatch")
    if dispatch is None:
        return None
    peak = None
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        peak = int(torch.cuda.max_memory_allocated())
    return {"pid": os.getpid(), "status": dispatch.status(),
            "launches": dispatch.launches(), "peak_bytes": peak}


# -------------------------------------------------------------- child main
def worker_main(address: str, wid: int, factory: Any,
                sleep_per_task: float = 0.0, poll: float = 1e-3,
                trace: bool = False, spawned: bool = False) -> None:
    """Child-process entry point: connect, say hello, self-schedule.

    ``factory`` is the runner (already the callable, or anything whose
    ``setup()`` builds heavy state in-child).  Any exception is reported
    upward as an ``("error", wid, repr)`` message before exiting, so an
    errored run surfaces instead of silently hanging the master.
    ``spawned`` says the child is a fresh interpreter; a runner that
    declares ``start_method = "spawn"`` refuses to run in a forked one.
    A forked child that inherited torch computes on one thread: the
    parent's intra-op pool does not survive a fork.

    With ``trace`` on, the worker records its execution spans locally
    (ABSOLUTE ``time.monotonic()`` timestamps — CLOCK_MONOTONIC is
    system-wide on this single-host testbed, so the master aligns them
    by subtracting its own run-start instant) and ships the pending
    batch as a ``("trace", wid, rows)`` message immediately before each
    report and at clean shutdown.  A SIGKILLed worker loses whatever it
    had not shipped yet — its lane simply ends, which is exactly what a
    flight recorder should show.
    """
    from repro_torch.core.trace import EV_EXEC   # int constant; cheap
    conn = transport.connect(address)
    pending: list = []
    try:
        conn.send(("hello", wid, os.getpid()))
        runner = factory
        if not spawned:
            if getattr(runner, "start_method", "fork") == "spawn":
                raise RuntimeError(
                    f"{type(runner).__name__} runs on the card and needs "
                    f"a fresh interpreter (start_method='spawn'); a "
                    f"forked child cannot use CUDA")
            if "torch" in sys.modules:
                sys.modules["torch"].set_num_threads(1)
        setup = getattr(runner, "setup", None)
        if callable(setup):
            setup()
        while True:
            conn.send(("request", wid))
            msg = conn.recv()
            if msg is None or msg[0] == "done":
                if pending:
                    conn.send(("trace", wid, pending))
                return
            if msg[0] == "wait":
                time.sleep(msg[1])
                continue
            chunk = msg[1]                        # ("assign", Chunk)
            t0 = time.monotonic()
            payload = runner(list(chunk.tasks()))
            if sleep_per_task > 0.0:
                time.sleep(sleep_per_task * chunk.size)
            dt = time.monotonic() - t0
            if trace:
                pending.append((EV_EXEC, t0, wid, chunk.seq, chunk.start,
                                chunk.size, chunk.origin_seq, dt))
                conn.send(("trace", wid, pending))
                pending = []
            info = kernel_info()
            if info is not None:
                conn.send(("kernels", wid, info))
            conn.send(("report", wid, chunk, payload, dt,
                       {wid: chunk.size}))
    except transport.TransportError:
        pass                        # master tore the run down under us
    except BaseException as e:      # noqa: BLE001 — forward, then die
        try:
            conn.send(("error", wid, repr(e)))
        except transport.TransportError:
            pass
    finally:
        conn.close()
