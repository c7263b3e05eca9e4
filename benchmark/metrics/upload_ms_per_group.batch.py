"""Device time of the host-to-device copies a dispatch group, in ms: the
traced copies over the program's count of groups dispatched."""
LAYER, MOVES, SOURCE = "upload", "compress_mb_s", "device_trace"


def read(rec):
    t, st = rec.get("trace"), rec.get("stats") or {}
    if not t or not t["htod_count"] or not st.get("dispatches"):
        return None
    return 1e3 * t["htod_s"] / st["dispatches"]
