"""Seconds in the program's trace extraction (pipeline.extract_traces:
demux, slice parse, the native extractor), summed over the worker threads,
per MB of input finished."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_span"


def read(rec):
    return readings.per_mb(rec, readings.span(rec, "extract", "total"))
