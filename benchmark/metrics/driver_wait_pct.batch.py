"""The share of the window the corpus driver's main thread spent waiting on
its extraction futures, in %."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "corpus driver", "compress_mb_s", "program_span"


def read(rec):
    wait = readings.span(rec, "extraction wait")
    units = readings.finished(rec)
    if wait is None or not units:
        return None
    return 100.0 * wait / units[-1]["t1"]
