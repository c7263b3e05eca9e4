"""Run one cell of BENCHMARK.json once, on the card, and print the result.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The last line of standard output is one JSON object: `correct`, `attempted`
and `failed` (files), `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, the numbers that decide `correct` beside their limits,
which are also the last lines of standard error.  Exits non-zero, printing
no result, where no card is present or fewer than the cell asks for, where
the program cannot be imported, and where JAX or the JAX package was loaded
in this process."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"
    return out.splitlines()[0] if out else "unknown"


def report(rec, trace):
    """Lines for the reader of the log: what the numbers were taken over."""
    from benchmark.harness import readings
    units = readings.finished(rec)
    lat = readings.latencies_s(rec)
    log(f"window: {len(rec['units'])} {rec['unit']}s sent, {len(units)} "
        f"returned, {rec['files_attempted']} files, "
        f"{sum(u['bytes'] for u in units) / 1e6:.3f} MB in "
        f"{rec['window_s']:.3f} s (nominal {rec['seconds']} s)")
    log(f"this process kept {rec['cpu_s'] / max(rec['window_s'], 1e-9):.2f} "
        f"cores busy over the window")
    if rec["unit"] == "job":
        log("job seconds: " + ", ".join(f"{u['t1'] - u['t0']:.3f}"
                                        for u in rec["units"]))
    errors = {u["error"] for u in rec["units"] if u["error"]}
    for e in sorted(errors)[:5]:
        log(f"a call raised: {e}")
    if rec["unit"] == "file" and lat:
        log(f"file latency over {len(lat)} files: p50 "
            f"{1e3 * readings.percentile(lat, 50):.3f} ms, p95 "
            f"{1e3 * readings.percentile(lat, 95):.3f} ms, p99 "
            f"{1e3 * readings.percentile(lat, 99):.3f} ms")
    if rec["stats"]:
        log(f"program stats over the window: {rec['stats']}")
    if trace:
        log(f"spans: {rec['spans']}")
        log(f"groups traced: {len(rec['groups'])}; device busy "
            f"{rec['trace']['busy_s']:.6f} s of "
            f"{rec['trace']['trace_window_s']:.6f} s")
        roof = readings.lane_roofline_pct(rec)
        if roof is not None:
            log(f"lane kernel at {roof:.3f}% of its roofline, against the "
                f"card's published peaks; card and power limit: "
                f"{card_power_limit()}")


def result_line(spec, cell, rec, checks, trace, kind):
    """The result's object, `checks` last; None where an end-to-end
    metric of the cell has nothing to read."""
    from benchmark.harness import drive

    metrics = {}
    for m in spec.metrics(cell["name"], trace):
        value = spec.reader(m["name"]).read(rec)
        if value is None:
            if not trace:
                log(f"end-to-end metric {m['name']} has nothing to read")
                return None
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": drive.correct(checks),
              "attempted": rec["files_attempted"],
              "failed": rec["files_failed"], "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["trace_window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    trace = bool(args.trace)

    # every build and kernel cache inside the checkout, at fixed paths
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")

    from benchmark.harness.spec import Spec
    spec = Spec()
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell['chips']}")
        return 2

    from benchmark.harness import drive
    rec, checks = drive.run_cell(spec, args.workload, args.seed, args.seconds,
                                 trace, device="cuda")
    report(rec, trace)

    result = result_line(spec, cell, rec, checks, trace,
                         torch.cuda.get_device_name(0))
    if result is None:
        return 4
    banned = drive.banned_modules()
    if banned:
        log(f"modules that must not load in a run were loaded: {banned}")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        log(f"check {name} {c['value']} {bound}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
