"""What the metric readers share: quantities of a run's record (see
drive.run_cell).  Each returns None where the record has nothing to read."""

import numpy as np

from . import roofline


def finished(rec):
    """The units of the window that returned without raising."""
    return [u for u in rec["units"] if u["error"] is None]


def input_mb(rec):
    mb = sum(u["bytes"] for u in finished(rec)) / 1e6
    return mb or None


def latencies_s(rec):
    return [u["t1"] - u["t0"] for u in finished(rec)]


def span(rec, name, part="self"):
    """A span's seconds over the window (0 where it never ran), or None
    in a run without spans."""
    if "spans" not in rec:
        return None
    return rec["spans"].get(name, {}).get(part, 0.0)


def per_mb(rec, seconds):
    mb = input_mb(rec)
    return None if seconds is None or mb is None else seconds / mb


def idle_pct(rec):
    t = rec.get("trace")
    if not t or not t["trace_window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["trace_window_s"])


def kernel_s(rec, fragment):
    """Device seconds of the operations whose name holds `fragment`."""
    t = rec.get("trace")
    if not t:
        return None
    return sum(s for name, (_, s) in t["ops"].items() if fragment in name)


def lane_roofline_pct(rec):
    """The fused lane kernel's least time over its traced time, summed over
    its launches: 100 x sum(bound) / sum(kernel)."""
    spent = kernel_s(rec, "lane_encode_streams")
    groups = rec.get("groups") or []
    if not spent or not groups:
        return None
    bound = sum(roofline.launch_bound_ms(g["rows"], g["Bp"], g["bins"],
                                         g["stored"] or 0, g["index"])[0]
                for g in groups) / 1e3
    return 100.0 * bound / spent


def percentile(values, q):
    return float(np.percentile(values, q)) if values else None
