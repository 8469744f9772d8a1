"""Build and load the port's hand-written CUDA kernels.

Each source under `gpv_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into a shared library with a plain C interface, in `gpv_tpu_torch/_build/`,
and loaded with `ctypes`. The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and a built one is
reused. Nothing is built at import: the first wrapper call on a CUDA tensor
builds what it needs, and `build_all()` builds every source at once, one
`nvcc` per source started together.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
# csrc/<name>.cu -> lib<name>_<hash>.so
SOURCES = ("attention", "attention_tile", "attention_decode",
           "ms_deform_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "gpv_tpu_torch are built from source at first use")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc for csrc/<name>.cu; None when it is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file


def build_all() -> float:
    """Build every source not yet built, all nvcc runs in parallel.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [j for j in (_start(n) for n in SOURCES) if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:  # finish the other builds, then raise
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the build."""
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(job)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
