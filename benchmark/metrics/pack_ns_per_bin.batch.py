"""The lane pack's time a bin: the program's own stats (pack_s, summed over
the extraction workers, over bins), in ns."""
LAYER, MOVES, SOURCE = "lane pack", "compress_mb_s", "program_counter"


def read(rec):
    st = rec.get("stats") or {}
    if "trace" not in rec or not st.get("bins"):
        return None
    return 1e9 * st["pack_s"] / st["bins"]
