"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` launcher and compiles
on first use into its own shared library under ``build/repro_torch/`` at
the repository root (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<digest>.so <name>.cu

The file name carries a digest of the source, of every header under
``csrc/`` (``*.cuh``, which the sources share) and of the flags, so an
edited source or header rebuilds and a stale library is never loaded.
Sources include no PyTorch headers, so each build takes seconds;
``build`` starts one nvcc per missing library, all at once, and waits for
them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"paged_attention_ragged": "paged_attention_ragged.cu",
           "paged_attention": "paged_attention.cu",
           "paged_attention_ragged_quant": "paged_attention_ragged_quant.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from ``PATH``, else ``$CUDA_HOME/bin``, else /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, dict]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns ``{name: {"seconds": wall seconds (0.0 if already built),
    "ptxas": nvcc's resource report}}``. Raises ``RuntimeError`` with
    nvcc's output if any build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info = {n: {"seconds": 0.0, "ptxas": ""} for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        out = library_path(n)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        info[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use and loaded once."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
