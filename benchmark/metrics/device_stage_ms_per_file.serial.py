"""Host time a file in the device stage (lane_coder.encode_traces_lanes:
the pack into the group, the upload, the launch, the read-back wait, the
envelopes), in ms."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "device stage", "compress_mb_s", "program_span"


def read(rec):
    spent, lat = readings.span(rec, "device stage", "total"), readings.latencies_s(rec)
    return None if spent is None or not lat else 1e3 * spent / len(lat)
