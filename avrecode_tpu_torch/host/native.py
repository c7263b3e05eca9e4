"""ctypes binding for the C++ host library (libavtpu.so).

The native library is the production host path: the same self-verifying
compress/decompress as codec.py, byte-compatible (differential-tested), at
native speed.

The library is built at first use from host/src, by host/Makefile, into
build/torch_host/ under the repository root.  Its file name carries a hash
of the sources, the Makefile and the host CPU's feature flags: the build is
-march=native, so a library built on another machine (or from other
sources) is never loaded, only rebuilt.  Where no compiler is installed,
available() is False and callers degrade to the Python implementation; a
build that fails raises with the compiler's output.
"""

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

_HOST = Path(__file__).resolve().parent
BUILD_DIR = _HOST.parent.parent / "build" / "torch_host"

_LIB = None
_TRIED = False


def _cpu_flags():
    """The host CPU's architecture and feature flags (what -march=native
    keys the code on)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()} {flags}"


def library_path():
    """Where the library for the current sources and this host's CPU is
    built."""
    h = hashlib.sha256(_cpu_flags().encode())
    for src in [_HOST / "Makefile", *sorted((_HOST / "src").iterdir())]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavtpu_{h.hexdigest()[:16]}.so"


def build():
    """Build the library if it is not built yet; returns its path, or None
    where make or the compiler is missing.  Safe against several processes
    at once: one builds under a file lock, to a temporary name that is then
    renamed into place, and the others wait and find the result."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX", "g++")
    if not (shutil.which("make") and shutil.which(cxx)):
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # built while this process waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["make", "-s", "-C", str(_HOST), f"OUT={tmp}"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"libavtpu.so build failed ({res.returncode}): "
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, so)
    return so


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    path = build()  # a failed build raises, and again at the next call
    _TRIED = True
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.avtpu_compress_mt.restype = ctypes.c_size_t
    lib.avtpu_compress_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.avtpu_decompress_mt.restype = ctypes.c_size_t
    lib.avtpu_decompress_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.avtpu_xopen.restype = ctypes.c_void_p
    lib.avtpu_xopen.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.avtpu_xtrace.restype = None
    lib.avtpu_xtrace.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.avtpu_xclose.restype = None
    lib.avtpu_xclose.argtypes = [ctypes.c_void_p]
    lib.avtpu_refscore.restype = ctypes.c_int
    lib.avtpu_refscore.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.avtpu_gop_count.restype = ctypes.c_int
    lib.avtpu_gop_count.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.avtpu_compress_gops.restype = ctypes.c_size_t
    lib.avtpu_compress_gops.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.avtpu_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return _LIB


def available():
    return _load() is not None


def compress(data, scope="stream", threads=1):
    """threads: 1=serial, 0=auto (parallel GOPs, gop scope only)."""
    lib = _load()
    assert lib is not None
    scope_id = {"stream": 0, "slice": 1, "gop": 2}.get(scope, scope)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.avtpu_compress_mt(
        bytes(data), len(data), scope_id, threads, ctypes.byref(out)
    )
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.avtpu_free(out)


class _XtractHandle:
    """Owns the native extract handle; closed when the last trace view is
    garbage-collected (traces keep a reference)."""

    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __del__(self):
        if self._ptr:
            self._lib.avtpu_xclose(self._ptr)
            self._ptr = None


class NativeTrace:
    """Per-slice/GOP bin trace from the native extractor (device-stage
    input).  `recs` is the packed u64 record array, byte-aligned as two
    u32 halves for cheap device unpacking:
        lo32 = slot(24) | bit<<24;  hi32 = pcab(16) | p1<<16
    viewed zero-copy over the native buffer.  p1 is the exact model
    probability for the bin (recorder adapts like the encoder), enabling
    the estimator-free lane-parallel coder kernel; slot/pcab feed the
    est-on-device kernels.  slots/bits/pcabs/p1s derive lazily."""

    __slots__ = ("recs", "limits", "cls", "_handle", "_slots", "_bits",
                 "_pcabs", "_p1s")

    def __init__(self, recs, limits, cls=None, handle=None):
        self.recs = recs
        self.limits = limits
        self.cls = cls if cls is not None else limits[:0]
        self._handle = handle  # keeps the native buffers alive
        self._slots = self._bits = self._pcabs = self._p1s = None

    def __len__(self):
        return len(self.recs)

    def recs32(self):
        """Zero-copy view as [n, 2] u32 (lo, hi) for x64-free device upload."""
        import numpy as np

        return self.recs.view(np.uint32).reshape(-1, 2)

    @property
    def slots(self):
        import numpy as np

        if self._slots is None:
            if len(self.limits) == 0 and len(self.recs):
                raise ValueError(
                    "trace extracted with want_slots=False: slot ids were "
                    "not remapped (lane-parallel consumers read bit/p1 only)"
                )
            self._slots = (self.recs & 0xFFFFFF).astype(np.int32)
        return self._slots

    @property
    def bits(self):
        import numpy as np

        if self._bits is None:
            self._bits = ((self.recs >> 24) & 1).astype(np.uint8)
        return self._bits

    @property
    def pcabs(self):
        import numpy as np

        if self._pcabs is None:
            self._pcabs = ((self.recs >> 32) & 0xFFFF).astype(np.uint16)
        return self._pcabs

    @property
    def p1s(self):
        import numpy as np

        if self._p1s is None:
            self._p1s = (self.recs >> 48).astype(np.uint16)
        return self._p1s


def extract(data, scope="slice", threads=1, want_slots=True):
    """Native host stage of the device pipeline: returns
    (sps_list, pps_list, blocks, traces) matching codec._scan_blocks
    output for the scope.  Slice scope: every slice block carries its
    NativeTrace; GOP scope: the first slice of each GOP carries the GOP
    trace, continuations carry b"" (the container's empty-blob marker).
    Trace record arrays are zero-copy views over native memory, kept
    alive by the traces themselves.

    threads: 1=serial, 0=auto (parallel GOP jobs, gop scope only).
    want_slots=False skips the export-time slot remap / halving-limit
    build (model.h::finalize_trace): the lane-parallel device coder reads
    only (bit, p1) from the records, fields the remap never touches, so
    traces land one pass cheaper.  slots/limits are then unavailable."""
    import numpy as np

    from ..utils.container import KIND_LITERAL, KIND_SLICE, Reader

    lib = _load()
    assert lib is not None
    scope_id = {"slice": 1, "gop": 2}[scope]
    meta_p = ctypes.POINTER(ctypes.c_uint8)()
    meta_len = ctypes.c_size_t()
    n_traces = ctypes.c_size_t()
    ptr = lib.avtpu_xopen(
        bytes(data), len(data), scope_id, threads, 1 if want_slots else 0,
        ctypes.byref(meta_p), ctypes.byref(meta_len), ctypes.byref(n_traces),
    )
    if not ptr:
        raise ValueError("native extract failed")
    handle = _XtractHandle(lib, ptr)
    blob = ctypes.string_at(meta_p, meta_len.value)  # meta is small

    traces = []
    for i in range(n_traces.value):
        recs_p = ctypes.POINTER(ctypes.c_uint64)()
        n_bins = ctypes.c_size_t()
        lim_p = ctypes.POINTER(ctypes.c_uint8)()
        cls_p = ctypes.POINTER(ctypes.c_uint8)()
        n_slots = ctypes.c_size_t()
        lib.avtpu_xtrace(
            ptr, i, ctypes.byref(recs_p), ctypes.byref(n_bins),
            ctypes.byref(lim_p), ctypes.byref(cls_p), ctypes.byref(n_slots),
        )
        recs = (
            np.ctypeslib.as_array(recs_p, shape=(n_bins.value,))
            if n_bins.value else np.zeros(0, np.uint64)
        )
        limits = (
            np.ctypeslib.as_array(lim_p, shape=(n_slots.value,)).astype(np.int32)
            if n_slots.value else np.zeros(0, np.int32)
        )
        cls = (
            np.ctypeslib.as_array(cls_p, shape=(n_slots.value,)).astype(np.int32)
            if n_slots.value else np.zeros(0, np.int32)
        )
        traces.append(NativeTrace(recs, limits, cls, handle))

    r = Reader(blob)
    sps = [r.blob() for _ in range(r.varint())]
    pps = [r.blob() for _ in range(r.varint())]
    blocks = []
    ti = 0
    for _ in range(r.varint()):
        kind = r.u8()
        if kind == KIND_LITERAL:
            blocks.append((KIND_LITERAL, r.blob()))
            continue
        nal_size = r.varint()
        head = r.blob()
        mb_count = r.varint()
        drop = r.varint()
        tail = r.blob()
        gaps = [(r.varint(), r.blob()) for _ in range(r.varint())]
        if not r.u8():  # gop continuation: no trace carried
            blocks.append(
                (KIND_SLICE, nal_size, head, mb_count, drop, tail, b"", gaps))
            continue
        t = traces[ti]
        ti += 1
        blocks.append((KIND_SLICE, nal_size, head, mb_count, drop, tail, t, gaps))
    return sps, pps, blocks, traces


def decompress(blob, threads=1):
    lib = _load()
    assert lib is not None
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.avtpu_decompress_mt(bytes(blob), len(blob), threads, ctypes.byref(out))
    if not out:
        raise ValueError("native decompress failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.avtpu_free(out)


def refscore(data):
    """Reference-model replay (src/refscore.h): returns the idealized
    recode-stream size the reference recoder's probability model would
    produce for this file's CABAC payloads, for the ratio-parity table
    (reference recode.cpp:683-827 keying, 1037-1054 estimator dynamics).

    Returns a dict: ref_stream_bytes, payload_bytes, slices_ok,
    slices_failed, bins, bits_{ctx,bypass,terminate,nnz,sig}, and
    ref_file_bytes = len(data) - payload + ref_stream (every non-CABAC
    byte charged 1:1, protobuf/container overhead uncounted — favors the
    reference)."""
    lib = _load()
    assert lib is not None
    out = (ctypes.c_double * 10)()
    rc = lib.avtpu_refscore(bytes(data), len(data), out)
    if rc:
        raise RuntimeError("refscore failed")
    d = {
        "ref_stream_bytes": out[0],
        "payload_bytes": int(out[1]),
        "slices_ok": int(out[2]),
        "slices_failed": int(out[3]),
        "bins": int(out[4]),
        "bits_ctx": out[5],
        "bits_bypass": out[6],
        "bits_terminate": out[7],
        "bits_nnz": out[8],
        "bits_sig": out[9],
    }
    d["ref_file_bytes"] = len(data) - d["payload_bytes"] + d["ref_stream_bytes"]
    return d


def gop_count(data):
    """GOP count from the cheap NAL + slice-header scan (no CABAC parse):
    the multi-host work decomposition unit."""
    lib = _load()
    assert lib is not None
    n = lib.avtpu_gop_count(bytes(data), len(data))
    if n < 0:
        raise ValueError("gop scan failed")
    return n


def compress_gops(data, lo, hi, threads=1):
    """Container FRAGMENT for GOPs [lo, hi) (gop scope).  Fragment 0
    carries the AVTR header; the fragment containing the last GOP carries
    the trailing literal; no fragment carries the end marker — join the
    fragments in order and append END (see parallel.multihost.stitch) to
    get a container byte-identical to compress(data, scope='gop') when
    every slice recodes.  Returns (fragment_bytes, total_gops)."""
    lib = _load()
    assert lib is not None
    out = ctypes.POINTER(ctypes.c_uint8)()
    total = ctypes.c_int()
    n = lib.avtpu_compress_gops(
        bytes(data), len(data), lo, hi, threads,
        ctypes.byref(out), ctypes.byref(total)
    )
    if not out:
        raise ValueError("compress_gops failed")
    try:
        return ctypes.string_at(out, n), total.value
    finally:
        lib.avtpu_free(out)
