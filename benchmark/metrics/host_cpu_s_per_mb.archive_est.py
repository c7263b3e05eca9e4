"""CPU seconds of the whole process (every thread) over the window, per MB
of input finished, in the archive cell: the GOP threads' extraction in the
8-byte form, the est stage's pack_rows and finalize_streams, the container."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "est device stage", "compress_mb_s", "host_clock"


def read(rec):
    return readings.per_mb(rec, rec.get("cpu_s"))
