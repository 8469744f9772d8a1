"""The runtime of the port's hand-written CUDA kernels: building,
loading, counting their launches, telling a traced call from an eager one.

Each source under `gpv_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into a shared library with a plain C interface (`SIGNATURES`), in
`gpv_tpu_torch/_build/`, and loaded with `ctypes`. The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a built one is reused. Nothing is built at import: the first wrapper
call on a CUDA tensor builds what it needs, and `build_all()` builds every
source at once, one `nvcc` per source started together.

One lock guards every counter, the kernel wrappers' (`count_launch`) and
the CUDA graphs' (`count`): the serving workers launch and replay from
several threads.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
_P, _I = ctypes.c_void_p, ctypes.c_int
# csrc/<name>.cu -> {C function: argtypes}; each returns a cudaError_t, and
# an `*_init` (its kernels' shared-memory and cluster limits) runs once
# when the library is loaded
SIGNATURES = {
    "attention": {"gpv_attn_fp32_init": [],
                  "gpv_attn_fp32": [_P] * 5 + [_I] * 11 + [_P],
                  "gpv_attn_fp32_bi": [_P] * 10 + [_I] * 10 + [_P]},
    "attention_tile": {"gpv_attn_tile_init": [],
                       "gpv_attn_tile": [_P] * 5 + [_I] * 10 + [_P],
                       "gpv_attn_tile_bi": [_P] * 10 + [_I] * 9 + [_P]},
    "attention_decode": {"gpv_attn_decode_init": [],
                         "gpv_attn_decode": [_P] * 5 + [_I] * 8 + [_P]},
    "ms_deform_attn": {"gpv_msdeform_init": [],
                       "gpv_msdeform": [_P] * 5 + [_I] * 7 + [
                           ctypes.POINTER(ctypes.c_int)] + [_I] * 4 + [_P]},
}
# csrc/<name>.cu -> lib<name>_<hash>.so
SOURCES = tuple(SIGNATURES)
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
    """The loaded library for csrc/<name>.cu, built first if needed, its
    functions typed (`SIGNATURES`) and its `*_init` run once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(job)
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
                if fn.endswith("_init"):
                    err = getattr(lib, fn)()
                    if err:
                        raise RuntimeError(f"{fn}: cudaError_t {err}")
            _libs[name] = lib
        return lib


def load_kernels() -> None:
    """Load every library that sets its kernels' limits when it is loaded
    (an `*_init`: K1's, K2's, the deformable sampling's), building it at
    first use, here and not inside a CUDA graph capture."""
    for name, fns in SIGNATURES.items():
        if any(fn.endswith("_init") for fn in fns):
            load(name)


def traced(t: torch.Tensor) -> bool:
    """True while torch.export or torch.compile traces the caller (the
    tensors are fake, or dynamo runs): a wrapper's call must become its
    op's node, and no CUDA graph is captured or replayed."""
    return torch.compiler.is_compiling() or type(t) is not torch.Tensor


# ---- counters ----

_count_lock = threading.Lock()
_capturing = threading.local()   # .tally while the thread captures


def count(counters, name: str, n: int = 1) -> None:
    """`n` more on the counter `name`, an attribute of `counters`."""
    with _count_lock:
        setattr(counters, name, getattr(counters, name) + n)


def count_launch(wrapper, variant: str) -> None:
    """One launch of `variant` on `wrapper`'s counters (`launches`,
    `variant_launches`). While the calling thread captures a CUDA graph
    (`count_into`) nothing runs, and the launch goes to the capture's
    tally instead."""
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        add_counts({(wrapper, variant): 1})
    else:
        tally[wrapper, variant] = tally.get((wrapper, variant), 0) + 1


@contextlib.contextmanager
def count_into(tally: dict):
    """Count the launches the calling thread makes inside the block into
    `tally` ({(wrapper, variant): launches}) and not on the wrappers'
    counters: the block captures a CUDA graph, which runs no kernel. Each
    replay of the graph then adds the tally (`add_counts`), so the counters
    hold the kernels that ran. The other threads count as usual."""
    saved = getattr(_capturing, "tally", None)
    _capturing.tally = tally
    try:
        yield
    finally:
        _capturing.tally = saved


def add_counts(tally: dict) -> None:
    """Add a capture's tally (`count_into`) to the wrappers' counters: one
    replay of its graph."""
    with _count_lock:
        for (wrapper, variant), n in tally.items():
            wrapper.launches += n
            wrapper.variant_launches[variant] += n
