"""Pass A of the native extractor's GOP jobs (the escape check, the slice
parse, CABAC decode and tail verify) per bin, in ns, in the broadcast
cell, whose every slice lies in an MBAFF frame: 1e9 x the program's stats
gop_parse_s / bins.  None where no bin lay in a field pair
(gop_field_bins 0, or a program without that counter)."""
LAYER, MOVES, SOURCE = "host extract", "compress_mb_s", "program_counter"


def read(rec):
    st = rec.get("stats") or {}
    if "trace" not in rec or not (st.get("gop_field_bins") and st.get("bins")):
        return None
    return 1e9 * st.get("gop_parse_s", 0.0) / st["bins"]
