"""The kernel build's cross-process lock (``repro_torch.kernels._build``).

Two processes started together on a stale tree call ``library()``; a
stub ``nvcc`` that counts its calls (and sleeps, so the two overlap)
shows that one compiled and the other loaded what it built.  The library
loader is stubbed too: the stub writes no real shared object.
"""

import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

NVCC = textwrap.dedent("""\
    #!/bin/sh
    echo "$*" >> "$NVCC_CALLS"
    sleep 1
    while [ $# -gt 0 ]; do
        if [ "$1" = "-o" ]; then touch "$2"; fi
        shift
    done
""")

CHILD = textwrap.dedent("""
    import pathlib, sys
    from repro_torch.kernels import _build
    root = pathlib.Path(sys.argv[1])
    _build.CSRC = root / "csrc"
    _build.BUILD_DIR = root / "build"
    _build.ctypes.CDLL = lambda path: path
    print("LOADED", _build.library())
""")


def test_two_processes_on_a_stale_tree_compile_once(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "a.cu").write_text("// one source\n")
    (tmp_path / "csrc" / "b.cu").write_text("// another\n")
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(NVCC)
    nvcc.chmod(0o755)
    calls = tmp_path / "calls.txt"
    env = dict(os.environ, PYTHONPATH=SRC, NVCC_CALLS=str(calls),
               PATH=f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "LOADED" in out and "libkernels.so" in out
    lines = calls.read_text().splitlines()
    # one build: a compile per source and one link, by one process
    assert sum(" -c " in f" {x} " for x in lines) == 2, lines
    assert sum("-shared" in x for x in lines) == 1, lines
    assert (tmp_path / "build" / "libkernels.so").exists()
