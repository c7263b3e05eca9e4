"""The serial parts of each file's extraction, per MB of input finished:
the native walk (NAL scan, unescape, slice headers) before the GOP jobs and
the stitch of the meta blob after them, the Python around the native call
(the meta decode, the trace views) and the release of the traces' buffers,
each on the thread that extracts the file, summed over the files (the
program's stats extract_walk_s, extract_stitch_s, extract_py_s and
extract_release_s)."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_span"
PARTS = ("extract_walk_s", "extract_stitch_s", "extract_py_s",
         "extract_release_s")


def read(rec):
    st = rec.get("stats") or {}
    if "trace" not in rec or not st.get("gop_jobs") or any(
            k not in st for k in PARTS):
        return None
    return readings.per_mb(rec, sum(st[k] for k in PARTS))
