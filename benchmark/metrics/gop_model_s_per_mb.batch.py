"""Pass B of the native extractor's GOP jobs (the model's replay of each
slice's records, writing each bin's p1), summed over the jobs' threads, per
MB of input finished: the program's stats gop_model_s."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_span"


def read(rec):
    st = rec.get("stats") or {}
    if "trace" not in rec or not st.get("gop_jobs"):
        return None
    return readings.per_mb(rec, st.get("gop_model_s"))
