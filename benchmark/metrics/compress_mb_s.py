"""Input bytes of every unit (a job or a file) finished in the window (the
one in flight at its end included) over the time from the window's start to
the end of the last of them, in MB (10^6 bytes) a second."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "end to end", "compress_mb_s", "host_clock"


def read(rec):
    mb, units = readings.input_mb(rec), readings.finished(rec)
    return mb / units[-1]["t1"] if mb and units else None
