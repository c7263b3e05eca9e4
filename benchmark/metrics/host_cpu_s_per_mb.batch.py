"""CPU seconds of the whole process (every thread) over the window, per MB
of input finished."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "corpus driver", "compress_mb_s", "host_clock"


def read(rec):
    return readings.per_mb(rec, rec.get("cpu_s"))
