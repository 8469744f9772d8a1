"""Build and load the port's native host runtime (C++ through ctypes, no
pybind11; counterpart of `gpv_tpu/native/build.py`).

`lap.cc` (the linear-assignment solver) and `imageproc.cc` (the uint8
resize and the fused colour jitter) compile with g++ into one shared
library under `gpv_tpu_torch/native/_build/`, named by a hash of the
sources and flags, at first use. The flags are the JAX package's, so the
same sources give the same pixels and assignments. A failed build raises
with the compiler's output; nothing falls back to another path. The
library is compiled under a per-process temporary name and renamed into
place, so processes racing on the first build never load half a file.
`load_native()` in a parent process before it forks loader workers leaves
the workers with the loaded library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
SOURCES = ("lap.cc", "imageproc.cc")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    """The C++ compiler: $CXX, else g++."""
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"gpv_native_{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Path:
    """Compile the library unless it is built (or `force`); its path."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.stem}.{os.getpid()}.so"
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(_DIR / s) for s in SOURCES), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native runtime cannot be built: "
                           f"{cmd[0]!r} did not start ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cmd[0]} failed building {out.name} (exit {proc.returncode}):"
            f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


_U8, _F32, _I32 = (ctypes.POINTER(t) for t in
                   (ctypes.c_uint8, ctypes.c_float, ctypes.c_int32))
_INT = ctypes.c_int
_SIGNATURES = {  # function: (restype, argtypes)
    "solve_lsap": (_INT, [_F32, _INT, _INT, _I32]),
    "solve_lsap_batch": (_INT, [_F32, _INT, _INT, _INT, _I32, _INT]),
    "resize_bilinear_u8": (None, [_U8, _INT, _INT, _INT, _U8, _INT, _INT]),
    "color_jitter_f32": (None, [_F32, _INT, _INT, _I32, _F32, _INT]),
}


def load_native() -> ctypes.CDLL:
    """The loaded library, built first if needed, its functions typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            for fn, (restype, argtypes) in _SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _lib = lib
        return _lib
