"""Self time of the read-back (lane_coder.collect_groups), the envelopes
(GroupStreams.envelope) and the container's serialisation
(pipeline._serialize), per MB of input finished."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "collect and container", "compress_mb_s", "program_span"


def read(rec):
    parts = [readings.span(rec, n) for n in ("collect", "envelope",
                                             "serialise")]
    return None if None in parts else readings.per_mb(rec, sum(parts))
