"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through :mod:`ctypes` — no
PyTorch headers, so a build takes seconds, not minutes.  Libraries land
in ``build/repro_torch_kernels/`` at the repository root, named by a
hash of their sources and flags: an edited source rebuilds, an unchanged
one loads the library already there.  Nothing is built at import time;
the first launch of a kernel builds every missing library at once, one
``nvcc`` process per source, all started together.

The target is Hopper only (``sm_90a``).  ``nvcc -Xptxas -v`` reports each
kernel's registers, shared memory and spills; the report is kept beside
the library as ``<library>.log`` (:func:`build_log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build", "load",
           "build_log"]

_CSRC = Path(__file__).resolve().parent / "csrc"
#: library name -> its translation unit in csrc/
SOURCES = {"fused_topk": "fused_topk.cu",
           "fused_topk_packed": "fused_topk_packed.cu"}
#: headers every source includes (part of each library's hash)
_HEADERS = ("fused_topk_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
_BUILD_TIMEOUT_S = 900

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels`` under the repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _library(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update(f.encode())
        h.update((_CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the repro_torch CUDA kernels are compiled at first "
        "use and need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")


def build() -> Dict[str, float]:
    """Compile every missing library, in parallel.  Returns the wall
    seconds of each build that ran; raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    todo = {n: _library(n) for n in SOURCES}
    todo = {n: lib for n, lib in todo.items() if not lib.exists()}
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    took, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        try:
            out, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {_BUILD_TIMEOUT_S} s"
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        lib.with_name(lib.name + ".log").write_text(out)
        os.replace(tmp, lib)     # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building missing libraries first."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build()
            lib = _LOADED[name] = ctypes.CDLL(str(_library(name)))
        return lib


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``) for library ``name``."""
    log = _library(name).with_name(_library(name).name + ".log")
    return log.read_text() if log.exists() else ""
