"""The port's import boundary: ``repro_torch`` (``cluster/`` and
``launch/`` included) loads neither ``jax`` nor any module of the JAX
package ``repro``, and its entry points never fall back to the CPU on
their own."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        if not m.name.endswith("__main__"):
            importlib.import_module(m.name)
    from repro_torch.apps import mandelbrot
    img = mandelbrot.escape_counts(64, 32, device="cpu")
    assert img.shape == (64, 64) and img.sum() > 0, img.sum()
    for pkg in ("repro_torch.adaptive", "repro_torch.obs",
                "repro_torch.core.devicesim", "repro_torch.core.theory",
                "repro_torch.core.refqueue", "repro_torch.cluster.master",
                "repro_torch.cluster.runners", "repro_torch.cluster._child",
                "repro_torch.launch.steps", "repro_torch.launch.dryrun",
                "repro_torch.launch.op_analysis", "repro_torch.launch.mesh",
                "repro_torch.distributed.partitioner"):
        assert pkg in sys.modules, pkg
    bad = sorted(k for k in sys.modules
                 if k == "jax" or k.startswith("jax.")
                 or k == "repro" or k.startswith("repro."))
    print("LOADED", len([k for k in sys.modules
                         if k.startswith("repro_torch")]))
    print("FORBIDDEN", bad)
""")


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
    n_loaded = int(out.stdout.split("LOADED")[1].split()[0])
    assert n_loaded >= 20, out.stdout         # every subpackage was walked


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.apps import mandelbrot, psia
    from repro_torch.configs import get_smoke
    from repro_torch.device import resolve
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="no GPU"):
        mandelbrot.compute_tile(0)
    with pytest.raises(RuntimeError, match="no GPU"):
        psia.compute_tasks([0], n=8, cloud_n=16)
    for arch in ("olmo-1b", "rwkv6-1.6b"):
        model = build_model(get_smoke(arch))
        with pytest.raises(RuntimeError, match="no GPU"):
            model.init(0)
        with pytest.raises(RuntimeError, match="no GPU"):
            model.init_cache(1, 4)
        with pytest.raises(RuntimeError, match="no GPU"):
            serve.main(["--arch", arch, "--smoke"])
    with pytest.raises(RuntimeError, match="no GPU"):
        train.main(["--arch", "olmo-1b", "--smoke"])
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve()
    assert resolve("cpu") == torch.device("cpu")
