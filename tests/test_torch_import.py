"""Import guard of the PyTorch port: it stands without JAX and without the
JAX package, and its entry points never fall back to the CPU silently."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _submodules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_with_jax_absent():
    """``sys.modules["jax"] = None`` makes any ``import jax`` raise; every
    module of the port must still import."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {_submodules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(REPO / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _bad_imports(source: str, depth: int) -> list[str]:
    """``import jax``/``jax.*``, ``repro``/``repro.*``, and relative
    imports that climb out of the port; ``depth`` is how many packages
    below ``repro_torch`` the file sits (-1 for a file outside it)."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                if node.level > depth + 1:
                    bad.append(f"line {node.lineno}: relative escape")
                continue
            names = [node.module or ""]
        else:
            continue
        bad += [f"line {node.lineno}: imports {n}" for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    return bad


def _depth(path: pathlib.Path) -> int:
    if PORT not in path.parents:
        return -1
    return len(path.relative_to(PORT).parts) - 1


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    assert _bad_imports(path.read_text(), _depth(path)) == []


@pytest.mark.parametrize("source", [
    "import jax\n", "import jax.numpy as jnp\n", "from jax import lax\n",
    "import repro.core\n", "from repro.core import slo\n",
    "from ... import x\n"])
def test_scan_catches_forbidden_imports(source):
    """The scan itself, on a file one package below the port's root."""
    assert _bad_imports(source, depth=1)
    assert not _bad_imports("from .. import core\nimport torch\n", depth=1)


def test_executor_without_device_raises_when_no_cuda():
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.engine import PagedTransformerExecutor
    from repro_torch.models import init_params

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_reduced("h2o-danube-1.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedTransformerExecutor(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedTransformerExecutor(cfg, params, device="cuda")
    ex = PagedTransformerExecutor(cfg, params, device="cpu", num_pages=8,
                                  page_size=4)
    assert ex.k_pages.device.type == "cpu"
