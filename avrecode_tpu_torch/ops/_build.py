"""Builds the port's CUDA kernels at first use and binds them with ctypes.

`nvcc` compiles csrc/*.cu into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds; one compile job per
source, run together), for sm_90a, into
build/torch_kernels/ under the repository root.  The file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built.  A build or load failure
raises with the compiler's output; nothing falls back to the plain torch
versions.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--threads", "0",
]


def _nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path():
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavtpu_torch_{h.hexdigest()[:16]}.so"


@functools.cache
def load():
    """Build (if needed) and load the kernel library; returns the CDLL with
    argtypes set.  The compiler's log (ptxas register and spill counts)
    is kept beside the library as <name>.log."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    lib.lane_encode_launch.argtypes = [ptr] * 7 + [ctypes.c_int, ctypes.c_int, ptr]
    lib.lane_encode_launch.restype = ctypes.c_int
    lib.est_encode_launch.argtypes = [ptr] * 13 + [ctypes.c_int] * 6 + [ptr]
    lib.est_encode_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def build_log():
    """nvcc's output for the current library (empty before the first build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""
