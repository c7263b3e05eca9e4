"""Host-side instruments of a run, from the benchmark's own files: the
process's peak resident set over the window, and spans around the calls
into the program's layers (copies of chip_smoke.py's PeakRSS and
chip_stages.py's Split and TimedFuture)."""

import concurrent.futures
import contextlib
import os
import threading
import time

RSS_EVERY_S = 0.02
PAGE = os.sysconf("SC_PAGE_SIZE")


def rss_now():
    """The process's resident set, in bytes (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


class PeakRSS:
    """The process's peak resident set while the block runs, sampled on a
    thread every RSS_EVERY_S, in bytes (chip_smoke.py's sampler, at a
    fourth of its rate and from statm: each sample holds the GIL for a
    few microseconds).  The kernel's own high-water mark cannot serve: it
    counts from the process's start, and the card's machine does not let a
    process reset it (/proc/self/clear_refs)."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()

    def _sample(self):
        while not self._stop.wait(RSS_EVERY_S):
            self.peak = max(self.peak, rss_now())

    def __enter__(self):
        self.peak = rss_now()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_now())


class Split:
    """Host time by span name: each wrapped call's time (`total`) and that
    time less the wrapped calls inside it on its thread (`self`); a span
    that runs on several threads at once is summed over them.  With
    `annotate`, each call is also a torch.profiler range of the same name,
    so that the device trace can say what the host was doing."""

    def __init__(self, annotate=False):
        self.spans = {}  # name -> [self s, total s, calls]
        self.local = threading.local()
        self.lock = threading.Lock()
        self.annotate = annotate

    def wrap(self, fn, name):
        def run(*args, **kwargs):
            stack = self.local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            ctx = contextlib.nullcontext()
            if self.annotate:
                import torch
                ctx = torch.profiler.record_function(name)
            t0 = time.perf_counter()
            try:
                with ctx:
                    return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                with self.lock:
                    s = self.spans.setdefault(name, [0.0, 0.0, 0])
                    s[0] += dt - inner
                    s[1] += dt
                    s[2] += 1
                if stack:
                    stack[-1] += dt
        return run


class TimedFuture:
    """A future whose result() a Split times (all the corpus driver asks of
    its futures); it holds the future, and not the other way round, so
    that a future let go is freed at once."""

    def __init__(self, fut, split, name):
        self.result = split.wrap(fut.result, name)


@contextlib.contextmanager
def patched(split, attrs, wait_span):
    """Wrap each (owner, attribute, span name) of `attrs` in the Split, and
    every thread pool's futures in TimedFuture (span `wait_span`), for the
    block; everything is put back after it."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in attrs]
    pool = concurrent.futures.ThreadPoolExecutor

    class TimedPool(pool):
        def submit(self, fn, *args, **kwargs):
            return TimedFuture(super().submit(fn, *args, **kwargs), split,
                               wait_span)

    try:
        for (owner, attr, fn), (_, _, name) in zip(saved, attrs):
            setattr(owner, attr, split.wrap(fn, name))
        concurrent.futures.ThreadPoolExecutor = TimedPool
        yield split
    finally:
        concurrent.futures.ThreadPoolExecutor = pool
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
