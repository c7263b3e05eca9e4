"""The share of the traced window in which no kernel, copy or fill ran on
the card, in %, in the broadcast cell (the lane main path beside the GOP
threads' field-pair parse and model)."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "device", "compress_mb_s", "device_trace"


def read(rec):
    return readings.idle_pct(rec)
