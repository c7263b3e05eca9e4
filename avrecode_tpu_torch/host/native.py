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
import threading
from pathlib import Path

from ..spans import closed, count, current, span

_HOST = Path(__file__).resolve().parent
BUILD_DIR = _HOST.parent.parent / "build" / "torch_host"

_LIB = None
_TRIED = False  # set once _LIB holds the library, or the build gave None
_LOAD_LOCK = threading.Lock()  # one build and load however many threads ask


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


def _source_key(dirs):
    """A hash of the Makefile, the files of `dirs` and the host CPU's
    flags."""
    h = hashlib.sha256(_cpu_flags().encode())
    files = [_HOST / "Makefile"]
    for d in dirs:
        files += sorted((_HOST / d).iterdir())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path():
    """Where the library for the current sources and this host's CPU is
    built."""
    return BUILD_DIR / f"libavtpu_{_source_key(['src'])}.so"


# make targets of host/Makefile besides the library -> the file each builds
TARGETS = {
    "libavtpu_asan.so": "libavtpu_asan.so",
    "libavtpu_tsan.so": "libavtpu_tsan.so",
    "tsan_driver": "tsan_driver",
    "fuzz": "fuzz_harness",
    "prof": "prof_driver",
}


def _locked_build(dest, cmd, what):
    """Run `cmd` (which writes the temporary path it is given) under the
    build lock unless `dest` exists, then rename the result into place.
    Raises with the compiler's output when the build fails."""
    if dest.exists():
        return dest
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if dest.exists():  # built while this process waited
            return dest
        tmp = dest.with_name(f"{dest.name}.{os.getpid()}.tmp")
        res = subprocess.run(cmd(tmp), capture_output=True, text=True)
        if res.returncode != 0:
            if tmp.is_dir():
                shutil.rmtree(tmp)
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{what} build failed ({res.returncode}): "
                f"{' '.join(cmd(tmp))}\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, dest)
    return dest


def build_target(target):
    """Build one of host/Makefile's debug, profiling or sanitizer targets
    (TARGETS) at first use and return the path of what it builds.  The
    build goes into a directory of build/torch_host/ keyed on the
    Makefile, the library's sources and the drivers, so an edited source
    rebuilds; several processes at once are safe, as in build().  Raises
    where make or the compiler is missing, or with the compiler's output
    where the build fails."""
    name = TARGETS[target]
    for tool in ("make", os.environ.get("CXX", "g++")):
        if not shutil.which(tool):
            raise RuntimeError(f"{target}: {tool} is not installed")
    out = BUILD_DIR / f"{target}_{_source_key(['src', 'drivers'])}"
    _locked_build(out, lambda tmp: ["make", "-s", "-C", str(_HOST), target,
                                    f"BUILD={tmp}"], target)
    return out / name


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
    return _locked_build(so, lambda tmp: ["make", "-s", "-C", str(_HOST),
                                          f"OUT={tmp}"], "libavtpu.so")


def sanitizer_missing(kind):
    """Why the compiler cannot build and run a program with
    -fsanitize=`kind` ("address" or "thread") here, or None where it can."""
    cxx = os.environ.get("CXX", "g++")
    if not shutil.which(cxx):
        return f"{cxx} is not installed"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = BUILD_DIR / f"probe_{kind}_{os.getpid()}"
    src = BUILD_DIR / f"{exe.name}.cc"
    src.write_text("int main() { return 0; }\n")
    try:
        res = subprocess.run([cxx, f"-fsanitize={kind}", "-o", str(exe),
                              str(src)], capture_output=True, text=True)
        if res.returncode == 0:
            res = subprocess.run([str(exe)], capture_output=True, text=True)
        if res.returncode != 0:
            return f"-fsanitize={kind}: {(res.stdout + res.stderr)[-300:]}"
        return None
    finally:
        src.unlink(missing_ok=True)
        exe.unlink(missing_ok=True)


def _load():
    """The loaded library, or None where it cannot be built.  Concurrent
    first calls (the corpus driver's extraction workers) wait for one build
    and load and all see its library."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if not _TRIED:
            path = build()  # a failed build raises, and again at the next call
            if path is not None:
                _LIB = _bind(ctypes.CDLL(str(path)))
            _TRIED = True
    return _LIB


def _bind(lib):
    """lib with every entry point's argument and result types set."""
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
    lib.avtpu_xopen_lane.restype = ctypes.c_void_p
    lib.avtpu_xopen_lane.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.avtpu_xlane.restype = None
    lib.avtpu_xlane.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.avtpu_xclose.restype = None
    lib.avtpu_xclose.argtypes = [ctypes.c_void_p]
    lib.avtpu_xstats.restype = ctypes.c_size_t
    lib.avtpu_xstats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_size_t,
    ]
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
    lib.avtpu_lane_pack.restype = ctypes.c_int
    lib.avtpu_lane_pack.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 4)
    lib.avtpu_lane_pack_codes.restype = ctypes.c_int
    lib.avtpu_lane_pack_codes.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 3)
    lib.avtpu_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    return lib


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

    @property
    def nbytes(self):
        """The bytes of its records: 8 a bin."""
        return self.recs.nbytes

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


class LaneTrace:
    """A GOP's bin trace in the lane form (extract_lanes): `codes`, one
    uint16 a bin, bits 0-11 the squash-table index of the bin's p1
    (SQUASH[index] == p1, the last such index) and bit 12 the bin, bits
    13-15 zero, viewed zero-copy over the native buffer.  That is all the
    lane coder reads; bits and p1s derive lazily.  The records' slot, pcab
    and class stay on the extraction's threads, so recs, slots and pcabs
    raise."""

    __slots__ = ("codes", "_handle", "_bits", "_p1s")

    def __init__(self, codes, handle=None):
        self.codes = codes
        self._handle = handle  # keeps the native buffer alive
        self._bits = self._p1s = None

    def __len__(self):
        return len(self.codes)

    @property
    def nbytes(self):
        """The bytes of its codes: 2 a bin."""
        return self.codes.nbytes

    def _absent(self, name):
        raise AttributeError(
            f"LaneTrace has no {name}: the lane form keeps each bin's bit and "
            "p1 only (2 bytes a bin); extract with native.extract for the "
            "u64 records")

    recs = property(lambda self: self._absent("recs"))
    slots = property(lambda self: self._absent("slots"))
    pcabs = property(lambda self: self._absent("pcabs"))

    @property
    def bits(self):
        import numpy as np

        if self._bits is None:
            self._bits = (self.codes >> 12).astype(np.uint8)
        return self._bits

    @property
    def p1s(self):
        if self._p1s is None:
            self._p1s = _squash()[self.codes & 0xFFF]
        return self._p1s


def _squash():
    """The squash table as a uint16 numpy array."""
    global _SQUASH
    if _SQUASH is None:
        import numpy as np

        from ..ops._mix_tables import SQUASH

        _SQUASH = np.asarray(SQUASH, np.uint16)
    return _SQUASH


_SQUASH = None

XSTATS = 13  # the counters avtpu_xstats writes


def _extraction_spans(lib, ptr, parent):
    """The native extraction's counters (avtpu_xstats) into the bound
    call's stats: its walk and stitch (extract_walk_s, extract_stitch_s);
    its GOP jobs (gop_jobs), their slices (gop_slices) and the slices not
    recoded (gop_slices_failed); pass A, the parse, and pass B, the
    model's replay, summed over the slices (gop_parse_s, gop_model_s); the
    jobs' wall and thread CPU time (gop_job_s, gop_cpu_s); the pool's
    threads times the GOP phase's wall (gop_pool_s); pass A's bins in MBAFF
    pairs decoded as fields (gop_field_bins, 0 on progressive input).
    Where the call is recorded, the walk, the GOP phase, each job (on its
    own thread) and the stitch are kept as spans under `parent`: the
    library's steady_clock is perf_counter_ns's clock."""
    c = (ctypes.c_int64 * XSTATS)()
    n_jobs = lib.avtpu_xstats(ptr, c, XSTATS, None, 0)
    (t_start, t_walked, t_joined, t_end, threads, jobs, slices, failed,
     parse_ns, model_ns, job_ns, cpu_ns, field_bins) = c
    for key, value in (
            ("extract_walk_s", (t_walked - t_start) / 1e9),
            ("extract_stitch_s", (t_end - t_joined) / 1e9),
            ("gop_jobs", jobs), ("gop_slices", slices),
            ("gop_slices_failed", failed), ("gop_parse_s", parse_ns / 1e9),
            ("gop_model_s", model_ns / 1e9), ("gop_job_s", job_ns / 1e9),
            ("gop_cpu_s", cpu_ns / 1e9),
            ("gop_pool_s", threads * (t_joined - t_walked) / 1e9),
            ("gop_field_bins", field_bins)):
        count(key, value)
    if parent is None:
        return
    times = (ctypes.c_int64 * (3 * n_jobs))()
    lib.avtpu_xstats(ptr, c, 0, times, n_jobs)
    closed("extract_walk", t_start, t_walked, parent=parent)
    phase = closed("gop_phase", t_walked, t_joined, parent=parent)
    for j in range(n_jobs):
        tid, t0, t1 = times[3 * j: 3 * j + 3]
        closed("gop_job", t0, t1, tid=tid, parent=phase)
    closed("extract_stitch", t_joined, t_end, parent=parent)


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
    traces land one pass cheaper.  slots/limits are then unavailable.

    In a call of an entry (spans.call) the native call is span
    extract_native, the Python after it (the counters, the trace views,
    the meta decode) extract_py, and the library's counters go to the
    call's stats (_extraction_spans)."""
    lib = _load()
    assert lib is not None
    scope_id = {"slice": 1, "gop": 2}[scope]
    data = bytes(data)
    return _extract_with(
        lib, lambda *out: lib.avtpu_xopen(
            data, len(data), scope_id, threads, 1 if want_slots else 0,
            *out), _record_view)


def extract_lanes(data, threads=0):
    """native.extract in the gop scope, each GOP's trace in the lane form:
    (sps_list, pps_list, blocks, traces) with LaneTraces, 2 bytes a bin,
    where extract gives NativeTraces of 8 (want_slots=False); the
    parameter sets, blocks and each trace's bits and p1s are extract's.
    For callers that read only each bin's (bit, p1): the lane coder.  The
    spans and counters are extract's."""
    lib = _load()
    assert lib is not None
    data = bytes(data)
    return _extract_with(
        lib, lambda *out: lib.avtpu_xopen_lane(data, len(data), threads,
                                               *out), _lane_view)


def _extract_with(lib, xopen, view):
    """Open an extraction (xopen(&meta, &meta_len, &n_traces), span
    extract_native), then, in span extract_py, its counters, each trace as
    view(lib, ptr, i, handle) makes it, and the meta blob decoded."""
    meta_p = ctypes.POINTER(ctypes.c_uint8)()
    meta_len = ctypes.c_size_t()
    n_traces = ctypes.c_size_t()
    with span("extract_native") as native_span:
        ptr = xopen(ctypes.byref(meta_p), ctypes.byref(meta_len),
                    ctypes.byref(n_traces))
    if not ptr:
        raise ValueError("native extract failed")
    handle = _XtractHandle(lib, ptr)
    with span("extract_py"):
        if current() is not None:
            _extraction_spans(lib, ptr, native_span.id)
        traces = [view(lib, ptr, i, handle) for i in range(n_traces.value)]
        return _decode_meta(meta_p, meta_len, traces)


def _record_view(lib, ptr, i, handle):
    """Trace i of an avtpu_xopen handle: its records viewed in place."""
    import numpy as np

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
    return NativeTrace(recs, limits, cls, handle)


def _lane_view(lib, ptr, i, handle):
    """Trace i of an avtpu_xopen_lane handle: its codes viewed in place."""
    import numpy as np

    codes_p = ctypes.POINTER(ctypes.c_uint16)()
    n = ctypes.c_size_t()
    lib.avtpu_xlane(ptr, i, ctypes.byref(codes_p), ctypes.byref(n))
    codes = (np.ctypeslib.as_array(codes_p, shape=(n.value,))
             if n.value else np.zeros(0, np.uint16))
    return LaneTrace(codes, handle)


def _decode_meta(meta_p, meta_len, traces):
    """(sps, pps, blocks, traces) from the meta blob, the GOP or slice
    blocks that carry a trace given theirs in order."""
    from ..utils.container import KIND_LITERAL, KIND_SLICE, Reader

    r = Reader(ctypes.string_at(meta_p, meta_len.value))  # meta is small
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


def lane_pack(traces, B, Bp):
    """One-pass lane packer (src/lanepack.cc) over NativeTraces' records
    or LaneTraces' codes (the index form always):
    each trace cut into ceil(T / B) lanes (at least one), rows of Bp >= B
    bins (a multiple of 32), every record read once.

    Returns (p1, bitw, lens, spans): p1 is the index form, uint8
    [L, 3 * Bp / 2] (two 12-bit squash-table indices in three bytes, as
    ops/lane_coder.pack_p1_idx packs them), where every valid bin's p1 lies
    in the squash table's image, and the u16 form, uint16 [L, Bp], where
    one does not; bitw int32 [L, Bp / 32], lens int32 [L], spans[i] the
    (lo, hi) lane range of traces[i].  Runs on host threads with the GIL
    released."""
    import numpy as np

    L = lane_rows(traces, B)
    pk = np.empty((L, 3 * Bp // 2), np.uint8)
    # written only where pk is not (never for LaneTraces)
    p1 = None if lane_form(traces) else np.empty((L, Bp), np.uint16)
    bitw = np.empty((L, Bp // 32), np.int32)
    lens = np.empty(L, np.int32)
    form, spans = lane_pack_into(traces, B, Bp, pk, p1, bitw, lens)
    return (pk if form else p1), bitw, lens, spans


def lane_form(traces):
    """Whether the traces are LaneTraces, which the packer reads from their
    codes (and an empty list, which has no rows)."""
    return all(isinstance(t, LaneTrace) for t in traces)


def native_traces(traces):
    """Whether the native packer takes the traces: NativeTraces, or
    LaneTraces, all of one kind."""
    return lane_form(traces) or all(hasattr(t, "recs32") for t in traces)


def lane_rows(traces, B):
    """Lane rows lane_pack cuts the traces into: ceil(T / B) a trace, at
    least one."""
    return sum(max(1, -(-len(t) // B)) for t in traces)


def lane_pack_into(traces, B, Bp, pk, p1, bitw, lens):
    """lane_pack into the caller's arrays: pk uint8 [L, 3 * Bp / 2], p1
    uint16 [L, Bp], bitw int32 [L, Bp / 32] and lens int32 [L], each
    C-contiguous with exactly L = lane_rows(traces, B) rows (a view of
    rows [r0, r0 + L) of a larger buffer places the traces' lanes at row
    r0).  Writes the index form into pk and returns (1, spans), or, where
    a valid p1 leaves the squash image, the u16 form into p1 and returns
    (0, spans); bitw and lens either way.  The other form's array may hold
    anything after the call: pk holds the index rows written before the
    first foreign p1 was found.

    LaneTraces (all of the traces, or none: a LaneTrace has no recs) are
    packed from their codes by avtpu_lane_pack_codes: their p1 always lie
    in the squash image, so the call writes the index form and returns
    (1, spans), and p1 is not read (it may be None)."""
    import numpy as np

    lib = _load()
    assert lib is not None
    lanes = lane_form(traces)
    counts = np.array([len(t) for t in traces], np.int64)
    k = np.maximum(1, -(-counts // B))
    ends = np.cumsum(k)
    lane0 = ends - k
    L = int(ends[-1]) if len(ends) else 0
    for name, a, dtype, shape in (
            ("pk", pk, np.uint8, (L, 3 * Bp // 2)),
            ("p1", p1, np.uint16, (L, Bp)),
            ("bitw", bitw, np.int32, (L, Bp // 32)),
            ("lens", lens, np.int32, (L,))):
        if name == "p1" and lanes and p1 is None:
            continue
        if (not isinstance(a, np.ndarray) or a.dtype != dtype
                or a.shape != shape or not a.flags.c_contiguous
                or not a.flags.writeable):
            raise ValueError(
                f"lane_pack_into: {name} must be a writeable C-contiguous "
                f"{np.dtype(dtype).name} array of shape {shape}")
    if lanes:
        recs = [np.ascontiguousarray(t.codes, np.uint16) for t in traces]
    else:
        recs = [np.ascontiguousarray(t.recs, np.uint64) for t in traces]
    ptrs = (ctypes.c_void_p * max(len(recs), 1))(
        *[r.ctypes.data for r in recs])
    head = (ctypes.cast(ptrs, ctypes.c_void_p), counts.ctypes.data,
            lane0.ctypes.data, len(recs), B, Bp, L, pk.ctypes.data)
    if lanes:
        form = lib.avtpu_lane_pack_codes(*head, bitw.ctypes.data,
                                         lens.ctypes.data)
    else:
        form = lib.avtpu_lane_pack(*head, p1.ctypes.data, bitw.ctypes.data,
                                   lens.ctypes.data)
    if form < 0:
        raise ValueError(f"lane_pack: bad shapes (B={B}, Bp={Bp})")
    return form, list(zip(lane0.tolist(), ends.tolist()))


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
