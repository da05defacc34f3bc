"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, which
loads with ``ctypes``.  The first use builds every source at once, one
``nvcc`` process per file started together, into ``build/repro_torch/`` at
the repository root (``REPRO_TORCH_BUILD_DIR`` overrides it).  A library's
file name carries a hash of its source and flags, so an edited source never
loads a stale build.  Only the sources in the repository are compiled.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("band_gemm", "paged_decode", "flash_attention", "flash_decode",
           "wkv6", "freivalds")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()
build_seconds = 0.0          # wall time of the last build of every source


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}-{tag}.so"


def build_all() -> dict:
    """Compile every missing library in parallel; return ``{name: path}``.
    Raises with the compiler's output if any build fails."""
    global build_seconds
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n, p in paths.items() if not p.exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            (out / f"{n}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, building on first
    use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                _LIBS[n] = ctypes.CDLL(str(p))
            lib = _LIBS[name]
        return lib
