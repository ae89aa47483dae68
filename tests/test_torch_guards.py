"""Guards of the port's boundaries: no file of inclusivegan_torch, and not
chip_smoke.py, imports JAX or the JAX package, with no exception, and
nothing builds a kernel at import."""

import ast
import importlib
import os
import pkgutil

import pytest

import inclusivegan_torch
from inclusivegan_torch.ops import cuda_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "inclusivegan_torch")
FORBIDDEN = ("jax", "jaxlib", "inclusivegan_tpu")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    """Every module named by an import statement, an ``importlib``
    ``import_module`` call or ``__import__`` with a literal name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_scan_covers_the_package():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"chip_smoke.py", "inclusivegan_torch/run_generator.py",
            "inclusivegan_torch/ops/cuda_kernels.py",
            "inclusivegan_torch/models/stylegan2.py"} <= names
    # the JAX golden's writer lives in the tests, outside the package
    assert not any("make_golden" in n for n in names)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_golden_script_is_never_imported_by_the_package():
    for path in _port_sources():
        assert not any("make_golden" in m for m in _imported_modules(path)), path


def test_importing_every_module_builds_nothing():
    for mod in pkgutil.walk_packages(inclusivegan_torch.__path__,
                                     "inclusivegan_torch."):
        importlib.import_module(mod.name)
    assert cuda_kernels._lib is None


LAZY_ONLY = ("PIL", "lmdb", "h5py", "cryptography")  # inside the functions that need them
NEVER = ("sklearn", "matplotlib")  # the port has its own k-means and plot


def _top_level_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_optional_packages_are_imported_lazily_and_never_sklearn(path):
    anywhere = [m for m in _imported_modules(path) if m.split(".")[0] in NEVER]
    top = [m for m in _top_level_modules(path) if m.split(".")[0] in LAZY_ONLY]
    assert not anywhere and not top, (path, anywhere, top)
