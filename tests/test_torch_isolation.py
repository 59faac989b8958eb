"""The port stands alone: no jax, no ``repro`` module, no quiet CPU.

``src/repro_torch``, ``chip_smoke.py`` and ``examples/*_torch.py`` must
run on a GPU machine where the JAX package cannot be imported, and the
port's entry points, the six examples among them, must refuse to fall
back to the CPU when no GPU is present.
"""
import ast
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


EXAMPLES = sorted((REPO / "examples").glob("*_torch.py"))


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + EXAMPLES)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".")
               for f in FORBIDDEN)


def test_port_sources_import_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("repro.kernels.ops")
    assert _forbidden("jaxlib") and _forbidden("repro")
    assert not _forbidden("repro_torch.kernels")
    assert not _forbidden("jaxtyping")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "assert len(names) > 15, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ,
                                   PYTHONPATH=str(REPO / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from repro_torch import resolve_device
    from repro_torch.launch import serve, train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert len(EXAMPLES) == 6
    for path in EXAMPLES:
        main = runpy.run_path(str(path))["main"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


STDLIB_ONLY = ("__future__", "argparse", "ast", "dataclasses", "json",
               "pathlib", "sys")


def test_analysis_is_walked_and_imports_the_stdlib_only():
    """The static checker's 10 files are among the port's files and
    import nothing but the standard library (relative imports aside),
    so ``python -m repro_torch.analysis`` runs with no numpy, torch or
    jax importable."""
    files = [f for f in _port_files() if f.parent == PORT / "analysis"]
    assert len(files) == 10
    mods = {m.split(".")[0] for f in files for m in _imported_modules(f)}
    assert mods <= set(STDLIB_ONLY), mods
    code = ("import sys\n"
            "for m in ('torch', 'numpy', 'jax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.analysis import main\n"
            "sys.exit(main(['src/repro_torch', 'examples']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ,
                                   PYTHONPATH=str(REPO / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new finding(s), 16 baselined" in proc.stdout
