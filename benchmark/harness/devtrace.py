"""The device trace of a traced run: torch.profiler over the window, read
back from its Chrome trace (the host's ranges and the card's activity on one
clock).

What it gives (summarize): the seconds in which a kernel, copy or fill ran
on the card (their union), each device operation's count and seconds, the
host-to-device copies, and the idle gaps, each named by the innermost range
the main thread was in at its middle (the benchmark's spans, or `outside
the program` between calls)."""

import json
import os

WINDOW_RANGE = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
IDLE_OUTSIDE = "outside the program"
NAME_CHARS = 96  # of a device operation's name (a template's can run to 1,000)


def profile():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def host_range(name):
    import torch
    return torch.profiler.record_function(name)


def window_range():
    return host_range(WINDOW_RANGE)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(prof, tmpdir, top=10):
    """The trace's summary (see the module docstring); times in seconds."""
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW_RANGE
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} window ranges in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    main = win[0].get("tid")
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    ops = {}
    for e in dev:
        name = e["name"][:NAME_CHARS]
        n, s = ops.get(name, (0, 0.0))
        ops[name] = (n + 1, s + e["dur"] / 1e6)
    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in dev if e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    busy_s = sum(b - a for a, b in busy) / 1e6
    # the host's ranges on the main thread, innermost last when sorted by
    # length, longest first
    host = sorted((e for e in spans if e.get("cat") == "user_annotation"
                   and e.get("tid") == main and e["name"] != WINDOW_RANGE),
                  key=lambda e: -e["dur"])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = IDLE_OUTSIDE
        for e in host:
            if e["ts"] <= mid <= e["ts"] + e["dur"]:
                name = e["name"]
        gaps.append((name, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    htod = [e for e in dev if e.get("cat") == "gpu_memcpy"
            and "HtoD" in e["name"]]
    return {
        "busy_s": busy_s,
        "trace_window_s": (w1 - w0) / 1e6,
        "ops": {k: list(v) for k, v in ops.items()},
        "htod_s": sum(e["dur"] for e in htod) / 1e6,
        "htod_count": len(htod),
        "device_ops": sorted(([k, v[1]] for k, v in ops.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": [list(g) for g in gaps[:top]],
    }
