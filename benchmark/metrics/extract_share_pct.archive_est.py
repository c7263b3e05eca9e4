"""The share of the files' summed latency spent in the program's trace
extraction (pipeline.extract_traces, here in the 8-byte record form with
slots that the est path reads), in %."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_span"


def read(rec):
    spent, lat = readings.span(rec, "extract", "total"), readings.latencies_s(rec)
    return None if spent is None or not lat else 100.0 * spent / sum(lat)
