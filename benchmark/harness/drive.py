"""One run of one cell: set-up, the measured window, the check.

The program under test is avrecode_tpu_torch, reached through two entries:

  corpus  parallel/pipeline.device_compress_corpus(paths, ...): one call a
          job, the directory mode of the recompressor;
  file    parallel/pipeline.device_compress(bytes, ...): one call a file.

A traffic mix names its entry and its unit of work (a job or a file) and
the window sends the units back to back from one caller (a closed loop):
it starts units until `seconds` have passed, and the unit in flight at
that moment is finished and counted.  The record that the metric readers
read holds each unit's start, end and input bytes, the process's CPU time
and peak resident set over the window, the program's own stats, and in a
traced run the spans, the dispatched groups and the device trace."""

import contextlib
import functools
import hashlib
import itertools
import os
import shutil
import sys
import tempfile
import time

from . import devtrace, inputs, spans

# top-level module names that may not be loaded in a run's process
BANNED = ("jax", "jaxlib", "flax", "avrecode_tpu")
WAIT_SPAN = "extraction wait"


def seconds_since_process_start():
    """Seconds since this process started (/proc: the kernel's start time
    of the process against its uptime clock, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def program_entries(settings, device):
    """The program's two entries, bound to the configuration's settings."""
    from avrecode_tpu_torch.parallel import pipeline

    kw = dict(scope=settings["scope"],
              substream_bins=settings["substream_bins"], device=device)

    def corpus(files, stats):
        return pipeline.device_compress_corpus([f.path for f in files],
                                               stats=stats, **kw)

    def one(files, stats):
        (f,) = files
        with open(f.path, "rb") as fh:
            data = fh.read()
        return [pipeline.device_compress(data, **kw)]

    return {"corpus": corpus, "file": one}


def traced_spans():
    """(owner, attribute, span) of the calls into the program's layers
    that a traced run wraps."""
    from avrecode_tpu_torch.ops import lane_coder as tlc
    from avrecode_tpu_torch.parallel import pipeline

    return [
        (pipeline, "extract_traces", "extract"),
        (pipeline, "pack_lanes", "pack"),
        (pipeline, "encode_traces_lanes", "device stage"),
        (tlc, "collect_groups", "collect"),
        (tlc.GroupStreams, "envelope", "envelope"),
        (pipeline, "_serialize", "serialise"),
    ]


class GroupLog:
    """Each dispatched group's shape, taken where the program uploads it
    (its form, rows, width and bins, from the group's host buffers) and
    where it reads it back (the stream bytes stored), for the roofline."""

    def __init__(self):
        self.groups = []
        self.read = 0

    def attrs(self):
        from avrecode_tpu_torch.ops import lane_coder as tlc
        log = self

        def upload_group(group, n, dev, _real=tlc.upload_group):
            log.groups.append({
                "index": bool(group.index), "rows": int(n),
                "Bp": int(group.Bp), "bins": int(group.np[2][:n].sum()),
                "stored": None})
            return _real(group, n, dev)

        def read_group(n, out, nbytes, total, _real=tlc.read_group):
            got = _real(n, out, nbytes, total)
            if log.read < len(log.groups) and got is not None:
                log.groups[log.read]["stored"] = int(got[0].sum())
            log.read += 1
            return got

        return [(tlc, "upload_group", upload_group),
                (tlc, "read_group", read_group)]


def _digest(blob):
    return hashlib.sha256(blob).hexdigest() if isinstance(blob, bytes) else None


def run_window(jobs, mix, entry, seconds, rec, trace=False):
    """The closed loop; fills rec["units"] and rec["produced"] (key, digest
    or None) a file, in the order sent.  Traced, each call is a profiler
    range of its own, so that an idle gap inside the program but outside
    the spans is named by the call."""
    clock = time.perf_counter
    if trace:
        span = functools.partial(devtrace.host_range, f"{mix['entry']} call")
    else:
        span = contextlib.nullcontext
    t0 = clock()
    stats_sum = rec["stats"]
    if mix["unit"] == "job":
        work = (jobs.job(k) for k in itertools.count())
    elif mix["unit"] == "file":
        work = ([f] for f in jobs.files())
    else:
        raise ValueError(f"unknown unit {mix['unit']!r}")
    for files in work:
        if clock() - t0 >= seconds:
            break
        stats, err = {}, None
        s = clock()
        try:
            with span():
                outs = entry(files, stats)
        except Exception as e:  # a failed call is counted, not fatal
            outs, err = [], f"{type(e).__name__}: {e}"
        e = clock()
        outs = list(outs or [])
        outs += [None] * (len(files) - len(outs))
        rec["units"].append({"t0": s - t0, "t1": e - t0,
                             "bytes": sum(f.size for f in files),
                             "files": len(files), "error": err})
        rec["produced"] += [(f.key, _digest(o)) for f, o in zip(files, outs)]
        del outs
        for k, v in stats.items():
            stats_sum[k] = stats_sum.get(k, 0) + v


def warm(jobs, mix, entry):
    """The set-up's warm-up: the configuration's warm job through the
    mix's entry, as the window sends it (a file entry once a distinct
    file)."""
    files = jobs.warm_job()
    if mix["unit"] == "job":
        entry(files, {})
    else:
        for f in {f.key: f for f in files}.values():
            entry([f], {})


def run_cell(spec, cell_name, seed, seconds, trace, device="cuda",
             entries=None, settings=None, workers=None):
    """One run; returns (record, the checks).  `entries` replaces the
    program's (the benchmark's own tests break it underneath), `settings`
    the configuration's program settings (the control); the reference is
    always held to the configuration's."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    mix = spec.mix(cell["traffic"])
    stated = config["settings"]
    run_settings = dict(stated, **(settings or {}))
    if entries is None:
        entries = program_entries(run_settings, device)
    entry = entries[mix["entry"]]
    rec = {"cell": cell_name, "unit": mix["unit"], "units": [],
           "produced": [], "stats": {}, "seconds": seconds}
    workdir = tempfile.mkdtemp(prefix="benchmark-run-")
    try:
        jobs = inputs.Jobs(config, spec.base, seed, workdir)
        warm(jobs, mix, entry)
        split = group_log = prof = None
        span_attrs, replaced = [], []
        if trace:
            split, group_log = spans.Split(annotate=True), GroupLog()
            span_attrs, replaced = traced_spans(), group_log.attrs()
            prof = devtrace.profile()
            prof.__enter__()
        window = devtrace.window_range() if trace else contextlib.nullcontext()
        with _instrumented(split, span_attrs, replaced):
            rec["setup_seconds"] = seconds_since_process_start()
            c0 = time.process_time()
            with spans.PeakRSS() as rss, window:
                run_window(jobs, mix, entry, seconds, rec, trace)
                if trace:
                    _sync(device)
            rec["cpu_s"] = time.process_time() - c0
        rec["window_s"] = rec["units"][-1]["t1"] if rec["units"] else 0.0
        rec["rss_peak_bytes"] = rss.peak
        if trace:
            prof.__exit__(None, None, None)
            rec["spans"] = {k: {"self": v[0], "total": v[1], "calls": v[2]}
                            for k, v in split.spans.items()}
            rec["groups"] = group_log.groups
            rec["trace"] = devtrace.summarize(prof, workdir)
            del prof
        rec["memory_peak_bytes"] = _device_peak(device)
        rec["banned"] = banned_modules()
        checks = check(jobs, rec, stated["substream_bins"], workers)
        rec["files_attempted"] = len(rec["produced"])
        rec["files_failed"] = checks["failed_files"]["value"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return rec, checks


@contextlib.contextmanager
def _instrumented(split, span_attrs, replaced):
    """In a traced run, the spans (wrapped in the Split) and the group log
    (replacing the two attributes it watches) for the block."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in replaced]
    try:
        for owner, attr, fn in replaced:
            setattr(owner, attr, fn)
        with (spans.patched(split, span_attrs, WAIT_SPAN) if split
              else contextlib.nullcontext()):
            yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_peak(device):
    import torch
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def check(jobs, rec, substream_bins, workers=None):
    """Every container the window produced against the reference's: the
    numbers compared, each with its limit (see benchmark/harness/check
    in PERF.md)."""
    from ..reference import expected

    keys = sorted({k for k, _ in rec["produced"]})
    containers = expected.containers(jobs.reference_inputs(), substream_bins,
                                     workers)
    want = {k: hashlib.sha256(v).hexdigest()
            for k, v in jobs.expected(keys, containers,
                                      expected.splice).items()}
    failed = sum(d is None for _, d in rec["produced"])
    checked = [(k, d) for k, d in rec["produced"] if d is not None]
    mismatched = sum(d != want[k] for k, d in checked)
    return {
        "files_checked": {"value": len(checked), "at_least": 1},
        "failed_files": {"value": failed, "limit": 0},
        "mismatched_files": {"value": mismatched, "limit": 0},
    }


def correct(checks):
    return all(c["value"] <= c["limit"] if "limit" in c
               else c["value"] >= c["at_least"] for c in checks.values())
