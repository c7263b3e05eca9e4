"""Pass A of the native extractor's GOP jobs (the canonical-escape check,
the slice parse, CABAC decode and tail verify), summed over the jobs'
threads, per MB of input finished: the program's stats gop_parse_s."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_span"


def read(rec):
    st = rec.get("stats") or {}
    if "trace" not in rec or not st.get("gop_jobs"):
        return None
    return readings.per_mb(rec, st.get("gop_parse_s"))
