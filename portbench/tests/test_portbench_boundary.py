"""The benchmark's import boundary, read from the sources: no module of
it imports ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
no reference imports the port."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_scans_the_benchmark():
    assert len(FILES) > 20 and HERE / "run.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    """A reference imports torch, numpy and the other references only."""
    tree = ast.parse(path.read_text())
    assert imported(path) <= {"__future__", "contextlib", "numpy", "torch",
                              "portbench"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_top_level_names_compared_whole():
    """The run's check finds a module of the JAX package and passes
    over the port's, whose name begins with the package's."""
    import sys
    import types

    from portbench import harness
    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}
    assert not [m for m in harness.forbidden_modules()
                if m.startswith("repro_torch")]
    fake = "repro._portbench_probe"
    sys.modules[fake] = types.ModuleType(fake)
    try:
        assert fake in harness.forbidden_modules()
    finally:
        del sys.modules[fake]
