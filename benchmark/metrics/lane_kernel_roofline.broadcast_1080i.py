"""The fused lane kernel's share of its roofline, in %, in the broadcast
cell: the least time of each launch (benchmark/harness/roofline.py: its
bytes at 3.35 TB/s against its integer operations, from the group's form,
rows, width, bins and stored stream bytes) over the kernel's traced time,
summed over the launches."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "lane kernel", "compress_mb_s", "device_trace"


def read(rec):
    return readings.lane_roofline_pct(rec)
