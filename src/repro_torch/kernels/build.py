"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``.  Builds
happen at first use (or all at once, in parallel, through
:func:`build_all`), never at import, into ``<checkout>/build/repro_torch``
— a directory ``.gitignore`` lists.  The library name carries a hash of
the source, of the headers beside it (``csrc/*.cuh``) and of the flags,
so an edited source or header is rebuilt and stale libraries are never
loaded.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and ``-fmad=false`` so
no mul->add seam of the reference's arithmetic is contracted into an FMA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_quantize", "stochastic_quantize", "int8_matmul",
           "int8_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every header beside it (``csrc/*.cuh``, which a source may
    include) and of the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def start_nvcc(src: Path, out, *extra: str) -> subprocess.Popen:
    """Start one ``nvcc`` of ``src`` into the library ``out`` with the
    port's flags (``extra`` before them); the compiler's output, the
    ``ptxas -v`` lines among it, is the process's stdout."""
    cmd = [nvcc_path(), *extra, *NVCC_FLAGS, "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: (path, seconds, ptxas log)}``; raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            jobs[name] = (out, None, None, "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = start_nvcc(CSRC / f"{name}.cu", tmp)
        jobs[name] = (out, proc, tmp, time.perf_counter())
    result = {}
    for name, (out, proc, tmp, t0) in jobs.items():
        if proc is None:
            result[name] = (out, 0.0, "cached")
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        result[name] = (out, time.perf_counter() - t0, log)
    return result


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _, _ = build_all([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
