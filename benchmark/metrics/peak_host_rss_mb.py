"""The process's peak resident set over the window, sampled on a thread
every 20 ms (/proc/self/statm), in MB (10^6 bytes)."""
LAYER, MOVES, SOURCE = "end to end", "peak_host_rss_mb", "host_clock"


def read(rec):
    return rec["rss_peak_bytes"] / 1e6 or None
