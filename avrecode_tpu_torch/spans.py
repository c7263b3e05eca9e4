"""Spans and counters at the layer boundaries of the program's entries.

A span is a named interval of one thread's work inside one call of an
entry (parallel/pipeline.py's device_compress and device_compress_corpus):
its name, start and end (time.perf_counter_ns: CLOCK_MONOTONIC, the clock
of the native library's steady_clock), its parent (the span open on the
same thread when it opened; a worker thread's first span has the call's
root span), its thread (the OS thread id, as the profiler's trace names
threads) and its request: the call's id and the index of the input within
the call.  A span's self time is its duration less its children's on its
own thread (Recording.self_times).

Two sinks:
  - totals: each span adds its seconds to the caller's `stats` dict under
    "<name>_s", and count() adds the program's own counts and seconds (the
    native extractor's); numbers only, summed over the call's threads;
  - when the call is recorded, its spans are kept (a Recording) and each
    span opened on the calling thread is also a torch.profiler range of
    the span's name, which names the device trace's idle gaps.

A call is recorded where a torch profiler records on the calling thread
at the call's entry (one check a call), or where the caller is inside
recording().  Worker threads take the call's decision (bind): a profiler
records nothing on a thread that it was not started on, and reports itself
off there.  A call that is neither recorded nor given `stats` binds
nothing, and its spans and counts cost one thread-local lookup each.

recording() keeps the spans of the calls made inside it, worker spans and
the native GOP jobs included, and writes them as Chrome-trace JSON
(Recording.export) on the clock of torch.profiler's traces: microseconds
of CLOCK_REALTIME, which a profiler trace's event `ts` plus its
`baseTimeNanoseconds` / 1000 equals; each call maps CLOCK_MONOTONIC onto it
by one offset read at its start.
"""

import contextlib
import itertools
import json
import os
import sys
import threading
import time

__all__ = ["KEYS", "Recording", "Span", "bind", "call", "closed", "count",
           "current", "recording", "span"]

# what every recorded stats dict holds, from the call's start: the layers'
# span totals (seconds), the native extractor's counts and seconds (see
# host/native.py::extract), the traces' bins and the bytes of their
# per-bin records (parallel/pipeline.py::extract_traces), and the device
# stage's counts: the lane path's, then the est path's
# (ops/est_coder.py::encode_traces_est)
KEYS = (
    "extract_s", "extract_native_s", "extract_walk_s", "extract_stitch_s",
    "extract_py_s", "extract_release_s",
    "gop_jobs", "gop_slices", "gop_slices_failed", "gop_parse_s",
    "gop_model_s", "gop_job_s", "gop_cpu_s", "gop_pool_s",
    "gop_field_bins",
    "wait_s", "pack_s", "copy_s", "dispatch_s", "upload_s", "collect_s",
    "envelope_s", "serialise_s", "dispatches", "bins", "trace_bytes",
    "est_pack_s", "est_upload_s", "est_launch_s", "est_collect_s",
    "est_finalize_s", "est_launches", "est_traces", "est_padded_bins",
    "est_stored", "est_wait_s", "est_memory_cuts", "est_stage_traces",
)

_clock = time.perf_counter_ns
_local = threading.local()  # .frame: the thread's _Frame; .recordings
_call_ids = itertools.count(1)
_span_ids = itertools.count(1)


class Span:
    """One recorded span; t0 and t1 in perf_counter_ns, t1 None while
    open."""

    __slots__ = ("id", "parent", "name", "tid", "t0", "t1", "call", "index")

    def __init__(self, parent, name, tid, t0, call, index):
        self.id = next(_span_ids)
        self.parent, self.name, self.tid = parent, name, tid
        self.t0, self.t1 = t0, None
        self.call, self.index = call, index


class Recording:
    """The spans of the calls made inside recording(), in the order they
    opened (a native span in the order it was read back)."""

    def __init__(self):
        self.spans = []
        self.offsets = {}  # call id -> CLOCK_REALTIME ns less perf_counter_ns

    def self_times(self):
        """{span id: seconds}: each span's duration less its children's on
        its own thread."""
        own = {s.id: s.t1 - s.t0 for s in self.spans}
        tid = {s.id: s.tid for s in self.spans}
        for s in self.spans:
            if s.parent in own and tid[s.parent] == s.tid:
                own[s.parent] -= s.t1 - s.t0
        return {k: v / 1e9 for k, v in own.items()}

    def export(self, path):
        """Write the ended spans to `path` as a Chrome trace of complete
        events, in microseconds of CLOCK_REALTIME (see the module
        docstring)."""
        pid = os.getpid()
        events = [{"name": s.name, "ph": "X", "cat": "avtpu_span",
                   "pid": pid, "tid": s.tid,
                   "ts": (s.t0 + self.offsets[s.call]) / 1e3,
                   "dur": (s.t1 - s.t0) / 1e3,
                   "args": {"id": s.id, "parent": s.parent, "call": s.call,
                            "index": s.index}}
                  for s in self.spans if s.t1 is not None]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def recording():
    """Record every call of an entry made on this thread inside the block;
    yields the Recording."""
    rec = Recording()
    stack = _local.__dict__.setdefault("recordings", [])
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


class _Call:
    __slots__ = ("id", "stats", "lock", "spans", "root")

    def __init__(self, stats, spans):
        self.id = next(_call_ids)
        self.stats = stats if stats is not None else {}
        self.lock = threading.Lock()
        self.spans = spans  # the Recording's list, or None when not recorded
        self.root = None  # the root span's id, when recorded

    def add(self, key, value):
        with self.lock:
            self.stats[key] = self.stats.get(key, 0) + value


class _Frame:
    """A thread's binding to a call: its open recorded spans' ids, the
    default input index, and whether its spans are profiler ranges."""

    __slots__ = ("call", "stack", "index", "ranges", "tid")

    def __init__(self, c, index, ranges):
        self.call, self.index, self.ranges = c, index, ranges
        self.stack = [c.root]
        self.tid = threading.get_native_id()


def _profiler_on():
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def _bound(frame):
    saved = getattr(_local, "frame", None)
    _local.frame = frame
    try:
        yield
    finally:
        _local.frame = saved


@contextlib.contextmanager
def call(name, stats=None, index=None):
    """Bind one call of an entry to this thread for the block, as a root
    span `name`: its spans add to `stats` (zeroed under KEYS first) and,
    where the call is recorded, are kept.  `index` is the input's index for
    spans that give none."""
    recs = getattr(_local, "recordings", None)
    rec = recs[-1] if recs else None
    profile = _profiler_on()
    if stats is None and rec is None and not profile:
        yield
        return
    if stats is not None:
        for k in KEYS:
            stats.setdefault(k, 0)
    recorded = rec is not None or profile
    c = _Call(stats, (rec.spans if rec else []) if recorded else None)
    if rec is not None:
        rec.offsets[c.id] = time.time_ns() - _clock()
    frame = _Frame(c, index, profile)
    with _bound(frame), span(name) as root:
        c.root = root.id
        yield


def current():
    """The call bound to this thread, or None."""
    frame = getattr(_local, "frame", None)
    return frame.call if frame is not None else None


@contextlib.contextmanager
def bind(c, index=None):
    """Bind this (worker) thread to call `c` (current() on the thread that
    made the call) for the block, with input `index`; its spans are
    recorded where the call is, and never profiler ranges.  None binds
    nothing."""
    if c is None:
        yield
        return
    with _bound(_Frame(c, index, False)):
        yield


class span:
    """A span of this thread's call for the block (nothing where no call is
    bound): its seconds are added to the call's stats under "<name>_s", and
    where the call is recorded it is kept, and on the calling thread it is
    a profiler range too.  `index` is the input's index, where it is not
    the thread's.  `id` is the span's id where it is recorded, else None."""

    __slots__ = ("name", "index", "frame", "rec", "range", "t0", "id")

    def __init__(self, name, index=None):
        self.name, self.index = name, index
        self.rec = self.range = self.id = None

    def __enter__(self):
        f = self.frame = getattr(_local, "frame", None)
        if f is None:
            return self
        c = f.call
        if c.spans is not None:
            index = f.index if self.index is None else self.index
            self.rec = Span(f.stack[-1], self.name, f.tid, _clock(), c.id,
                            index)
            self.id = self.rec.id
            c.spans.append(self.rec)
            f.stack.append(self.id)
            if f.ranges:
                import torch
                self.range = torch.profiler.record_function(self.name)
                self.range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        f = self.frame
        if f is None:
            return False
        f.call.add(f"{self.name}_s", (_clock() - self.t0) / 1e9)
        if self.rec is not None:
            if self.range is not None:
                self.range.__exit__(None, None, None)
            self.rec.t1 = _clock()
            f.stack.pop()
        return False


def count(key, value=1):
    """Add `value` to the bound call's stats under `key` (nothing where no
    call is bound)."""
    f = getattr(_local, "frame", None)
    if f is not None:
        f.call.add(key, value)


def closed(name, t0, t1, tid=None, parent=None):
    """Keep a span that has already ended (t0, t1 in perf_counter_ns; the
    native library's steady_clock ns), where the bound call is recorded:
    on thread `tid` (default this one), under `parent` (default the span
    open on this thread).  Adds nothing to stats.  Returns its id, or
    None."""
    f = getattr(_local, "frame", None)
    if f is None or f.call.spans is None:
        return None
    s = Span(f.stack[-1] if parent is None else parent, name,
             f.tid if tid is None else tid, t0, f.call.id, f.index)
    s.t1 = t1
    f.call.spans.append(s)
    return s.id
