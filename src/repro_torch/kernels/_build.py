"""Build the CUDA kernels from ``repro_torch/csrc/*.cu`` and load them.

``nvcc`` compiles each source into an object (all started together),
links them into ``build/kernels/libkernels.so`` at the repository root,
and the library is loaded with ``ctypes``.  The sources have a plain C
interface and include no PyTorch header, so a build takes seconds.  The
build happens at first use, never at import; it is redone when a source
or a header it includes (``csrc/*.cuh``) is newer than the library.
The stale check and the compile hold an exclusive ``fcntl`` lock on
``build/kernels/.lock``, so processes started together on a stale tree
(the spawned workers of ``repro_torch.cluster``) build it once: the
first compiles, the others wait and then load what it built.
Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libkernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict = {}
#: what the last build printed (ptxas register/shared-memory report) and
#: how long it took; empty when the library was loaded as it stood
build_log: str = ""
build_seconds: float = 0.0


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale(lib: pathlib.Path) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(s.stat().st_mtime > built for s in CSRC.glob("*.cu*"))


def _compile() -> pathlib.Path:
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [exe, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"--- {src.name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        tmp_lib = pathlib.Path(tmp) / LIB_NAME
        link = subprocess.run(
            [exe, *ARCH, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib = BUILD_DIR / LIB_NAME
        os.replace(tmp_lib, lib)        # atomic: no half-written library
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return lib


@contextlib.contextmanager
def _build_lock():
    """Exclusive lock across processes on ``BUILD_DIR/.lock``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def library(*, rebuild: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, or always with
    ``rebuild`` while it is not loaded yet (thread- and process-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = BUILD_DIR / LIB_NAME
            with _build_lock():
                if rebuild or _stale(lib):
                    lib = _compile()
            _lib = ctypes.CDLL(str(lib))
        return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry ``name`` with its argument types set (``c_void_p`` for
    every pointer and the stream) and an ``int`` return code."""
    lib = library()
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} "
                           f"(cudaError_t)")
