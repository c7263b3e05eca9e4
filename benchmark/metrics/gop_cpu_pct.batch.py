"""The GOP jobs' thread CPU time over their wall time, in %: 100 x the
program's stats gop_cpu_s / gop_job_s (CLOCK_THREAD_CPUTIME_ID at each
job's start and end).  Under 100 where a job's thread waits for a core, as
when two files' GOP threads share the host's cores."""
LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_counter"


def read(rec):
    st = rec.get("stats") or {}
    if "trace" not in rec or not st.get("gop_job_s"):
        return None
    return 100.0 * st.get("gop_cpu_s", 0.0) / st["gop_job_s"]
