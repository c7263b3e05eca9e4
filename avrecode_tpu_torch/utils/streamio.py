"""Streaming container IO: compress/decompress between FILES with peak
memory bounded by a GOP window instead of the whole stream — the
productization gap for long 4K captures (BASELINE.md config 5; the
reference mmaps the whole input AND buffers the whole protobuf,
recode.cpp:1113/1128-1131).

Compression walks the input via mmap (OS-paged, evictable) and emits
container fragments one GOP window at a time (native compress_gops with
the lazy header-prefix walker: out-of-window GOPs only ever cost a ~4KB
header unescape per rescan).  Decompression scans the gop-scope container
structurally (no stream decode), then decodes one GOP group per step via
a self-contained sub-container, appending output incrementally — the same
decomposition multi-host sharding uses (parallel/multihost.py).
"""

import ctypes
import mmap
import os

from .container import KIND_END, scan_gop_groups as _scan_gop_groups


def _mmap_ro(path):
    """Read-only view of a file as a (file, mmap, buffer) triple.  The map
    is MAP_PRIVATE with PROT_WRITE so ctypes.from_buffer accepts it; pages
    stay file-backed and evictable (nothing ever writes)."""
    f = open(path, "rb")
    if os.fstat(f.fileno()).st_size == 0:
        return f, None, b""
    mm = mmap.mmap(f.fileno(), 0, flags=mmap.MAP_PRIVATE,
                   prot=mmap.PROT_READ | mmap.PROT_WRITE)
    return f, mm, mm


def _gops_buf(lib, buf, n, lo, hi, threads):
    out = ctypes.POINTER(ctypes.c_uint8)()
    total = ctypes.c_int()
    ln = lib.avtpu_compress_gops(ctypes.cast(buf, ctypes.c_char_p), n, lo,
                                 hi, threads, ctypes.byref(out),
                                 ctypes.byref(total))
    try:
        return ctypes.string_at(out, ln), total.value
    finally:
        if out:
            lib.avtpu_free(out)


def stream_compress(in_path, out_path, threads=0, window_gops=None,
                    low_memory=True):
    """File-to-file gop-scope compression with O(window) memory.

    Byte-identical to native.compress(data, 'gop') — fragments are the
    multi-host stitching units, so concatenation IS the container."""
    from ..host import native

    lib = native._load()
    assert lib is not None, "streaming IO needs the native library"
    f, mm, data = _mmap_ro(in_path)
    try:
        n = len(data)
        with open(out_path, "wb") as out:
            if n == 0:
                out.write(native.compress(b"", "gop", 1))
                return
            buf = (ctypes.c_uint8 * n).from_buffer(mm)
            # fragment 0 carries the header; probe it to learn gop count.
            # Each window re-walks the headers (O(file) scan, cheap vs the
            # CABAC parse thanks to the lazy walker), so the auto window
            # caps the number of rescans at ~48
            w0 = window_gops or 16
            frag, total = _gops_buf(lib, buf, n, 0, w0, threads)
            out.write(frag)
            win = window_gops or max(16, -(-total // 48))
            lo = w0
            while lo < total:
                hi = min(lo + win, total)
                frag, _ = _gops_buf(lib, buf, n, lo, hi, threads)
                out.write(frag)
                lo = hi
                if low_memory:
                    # drop resident file pages between windows: clean
                    # MAP_PRIVATE pages reload from disk on demand (the lazy
                    # walker re-touches only header prefixes), keeping peak
                    # RSS at O(window) instead of O(file)
                    mm.madvise(mmap.MADV_DONTNEED)
            out.write(bytes([KIND_END, 0]))  # the multihost stitch epilogue
            del buf
    finally:
        if mm is not None:
            import gc

            gc.collect()  # drop lingering ctypes exports before closing
            try:
                mm.close()
            except BufferError:
                pass  # freed at process exit; the map is read-only anyway
        f.close()


def stream_decompress(in_path, out_path, threads=0):
    """File-to-file decompression with O(GOP group) memory for gop-scope
    containers (other scopes decode whole — their model stream is global)."""
    from ..host import native

    f, mm, blob = _mmap_ro(in_path)
    try:
        view = memoryview(blob) if blob else memoryview(b"")
        scan = _scan_gop_groups(view) if blob else None
        with open(out_path, "wb") as out:
            if scan is None:
                out.write(native.decompress(bytes(blob), threads))
                return
            header_end, groups = scan
            header = bytes(view[:header_end])
            tail = bytes([KIND_END, 0])
            for lo, hi in groups:
                sub = header + bytes(view[lo:hi]) + tail
                out.write(native.decompress(sub, threads))
    finally:
        if mm is not None:
            del view
            mm.close()
        f.close()
