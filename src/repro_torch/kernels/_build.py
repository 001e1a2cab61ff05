"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` has a plain ``extern "C"`` interface and builds on
its own into a shared library under ``build/`` (listed in ``.gitignore``),
named after a hash of the source so an edited kernel is never served
stale.  The build happens at first use: :func:`library` builds whatever is
missing, every source in parallel (one ``nvcc`` each, all started
together), then loads the one asked for.  Nothing here runs at import.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` (Hopper, the ``a`` target; no fast-math).  ``-Xptxas
-v`` reports each kernel's registers and shared memory; that report is
kept beside the library as ``<lib>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

from ..obs.trace import stopwatch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("pairwise_dist", "gf2", "flash_attention",
           "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, ``$CUDA_HOME/bin`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every missing library of ``names`` in parallel; returns the
    seconds spent (0.0 when all were built already).  Raises with
    ``nvcc``'s output when a source does not compile."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with stopwatch("kernels/build", sources=",".join(todo)) as sw:
        procs: List[tuple] = []
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                                f"{log}")
                continue
            out.with_name(f"{out.name}.log").write_text(log)
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return sw.elapsed


def build_log(name: str) -> str:
    """``nvcc``'s report (``-Xptxas -v``) for a built library."""
    path = library_path(name)
    log = path.with_name(f"{path.name}.log")
    return log.read_text() if log.is_file() else ""


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing).

    ``signatures`` maps each exported function to its ``argtypes``; every
    function returns the ``cudaError_t`` of its launch as an ``int``.
    Pointers and the stream must be ``ctypes.c_void_p`` there, or ctypes
    passes them as 32-bit ints and cuts them.
    """
    lib = _LOADED.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error (a refused launch does
    not otherwise surface, not even at the next synchronize)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
