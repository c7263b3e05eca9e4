"""The share of the GOP job pools' thread time in which no job ran, in %:
100 x (1 - the jobs' wall time summed / each file's pool threads times its
GOP phase's wall, summed), from the program's stats gop_job_s and
gop_pool_s.  It reads the pool's tail, where threads wait for the last
job of a file."""
LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_span"


def read(rec):
    st = rec.get("stats") or {}
    if "trace" not in rec or not st.get("gop_pool_s"):
        return None
    return 100.0 * (1.0 - st.get("gop_job_s", 0.0) / st["gop_pool_s"])
