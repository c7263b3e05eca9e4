"""device_compress_corpus as a streaming pipeline, on the CPU
(avrecode_tpu_torch/parallel/pipeline.py with ops/lane_coder.py's
StreamingBatcher): several files extracted and packed at once, each on its
worker, which lets its traces go once packed; each dispatch group read
back before the next launches, each container serialised once its rows
are back.

Three clips (the CAVLC one through the Python parser) and a file with no
video, in groups of 100 rows: at every window and byte budget the
containers equal the JAX package's device_compress_corpus and the port's
codec.compress byte for byte, and the groups fall where the batcher before
streaming put them.  Along the way no more than the window's extractions
run at once, and their input bytes stay within EXTRACT_BYTES (or one file
runs alone); no pack of a corpus file runs on the main thread; no more
than the window plus one native extraction handles are alive, and no more
than two dispatched groups wait to be read back.  A failing extraction or
pack comes out of the call as raised and leaves every group it took
released and every extraction handle closed.  EXTRACT_WINDOW counts the
cores the process may run on, and the native library's first load, asked
for by several workers at once, builds once and serves them all."""

import concurrent.futures
import os
import subprocess
import sys
import threading
import time
import weakref

import pytest

from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline as tpipe
from test_torch_staging import _old_groups

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "cavlc_ipp.mkv"]
PYTHON_CLIP = 2  # extracted by the Python parser
ROWS = 100  # GROUP_ROWS of every call here
STALL_S = 0.1  # each extraction's sleep: the window's extractions overlap


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


DATAS = [_read(c) for c in CLIPS] + [b"not a video at all"]
N_VIDEOS = len(CLIPS)  # the inputs with traces


@pytest.fixture(scope="module", params=[1024, 1000], ids=lambda B: f"B{B}")
def want(request):
    """(B, the JAX corpus pipeline's containers, the old batcher's groups)
    of DATAS, checked against codec.compress."""
    B = request.param
    outs = jpipe.device_compress_corpus(DATAS, scope="gop", substream_bins=B)
    assert outs == [codec.compress(d, scope="gop", substream_bins=B)
                    for d in DATAS]
    order = sorted(range(len(DATAS)), key=lambda i: -len(DATAS[i]))
    files = []
    for i in order:
        traces = tpipe.extract_traces(DATAS[i], scope="gop",
                                      want_slots=False)[3]
        if traces:
            files.append((native.lane_rows(traces, B), True))
    return B, outs, _old_groups(files, ROWS)


class Probe:
    """Counts, over device_compress_corpus calls: extractions running at
    once, the input bytes submitted and not yet taken (the pool's futures,
    from submit to result), the thread of every lane pack (pack_lanes,
    native.lane_pack, native.lane_pack_into), live native extraction
    handles (a WeakSet of every _XtractHandle made), dispatched groups not
    yet read back, and the groups taken from and given back to the ring.
    `fail` names an input whose extraction raises Boom, `fail_pack` one
    whose pack raises Boom on its worker."""

    def __init__(self, monkeypatch, window, budget=None):
        self.lock = threading.Lock()
        self.running = self.most_running = 0
        self.held = self.most_held = 0
        self.packs = []  # (packer, thread ident) of every pack call
        self.handles = weakref.WeakSet()
        self.most_handles = 0
        self.waiting = self.most_waiting = 0
        self.groups = []  # (index form, rows) of each dispatch
        self.taken, self.released = [], []
        self.fail = self.fail_pack = None
        self.datas = []
        self.local = threading.local()  # the input a worker extracts
        monkeypatch.setattr(tpipe, "EXTRACT_WINDOW", window)
        if budget is not None:
            monkeypatch.setattr(tpipe, "EXTRACT_BYTES", budget)
        monkeypatch.setattr(tlc, "GROUP_ROWS", ROWS)
        real_extract = tpipe.extract_traces

        def extract(data, **kw):
            with self.lock:
                self.running += 1
                self.most_running = max(self.most_running, self.running)
            self.local.data = data
            try:
                time.sleep(STALL_S)
                if data == self.fail:
                    raise Boom("extraction failed on purpose")
                if data == DATAS[PYTHON_CLIP]:
                    kw["use_native"] = False
                return real_extract(data, **kw)
            finally:
                with self.lock:
                    self.running -= 1

        monkeypatch.setattr(tpipe, "extract_traces", extract)
        for owner, name in ((tpipe, "pack_lanes"), (tlc, "pack_lanes"),
                            (native, "lane_pack"), (native, "lane_pack_into")):
            monkeypatch.setattr(owner, name, self._pack(getattr(owner, name),
                                                        name))
        probe = self

        class Pool(concurrent.futures.ThreadPoolExecutor):
            def submit(self, fn, i):
                size = len(probe.datas[i])
                with probe.lock:
                    probe.held += size
                    probe.most_held = max(probe.most_held, probe.held)
                return Taken(super().submit(fn, i), size, probe)

        monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Pool)
        real_init = native._XtractHandle.__init__

        def init(handle, *args):
            real_init(handle, *args)
            with self.lock:
                self.handles.add(handle)
                self.most_handles = max(self.most_handles, len(self.handles))

        monkeypatch.setattr(native._XtractHandle, "__init__", init)
        real_dispatch, real_read = tlc.dispatch_group, tlc.read_group

        def dispatch(group, n, dev, bits_per_byte=4):
            self.groups.append((group.index, n))
            self.waiting += 1
            self.most_waiting = max(self.most_waiting, self.waiting)
            return real_dispatch(group, n, dev, bits_per_byte)

        def read(*args):
            self.waiting -= 1
            return real_read(*args)

        monkeypatch.setattr(tlc, "dispatch_group", dispatch)
        monkeypatch.setattr(tlc, "read_group", read)
        ring = tlc._groups
        real_take, real_release = ring.take, ring.release

        def take(*args):
            group = real_take(*args)
            self.taken.append(group)
            return group

        def release(group):
            self.released.append(group)
            real_release(group)

        monkeypatch.setattr(ring, "take", take)
        monkeypatch.setattr(ring, "release", release)

    def _pack(self, real, name):
        def pack(*args, **kw):
            with self.lock:
                self.packs.append((name, threading.get_ident()))
            if (name == "pack_lanes" and self.fail_pack is not None
                    and getattr(self.local, "data", None) == self.fail_pack):
                raise Boom("pack failed on purpose")
            return real(*args, **kw)
        return pack

    def run(self, datas, B):
        stats = {}
        self.groups, self.packs, self.datas = [], [], datas
        self.held = self.most_held = 0
        outs = tpipe.device_compress_corpus(
            datas, scope="gop", substream_bins=B, device="cpu", stats=stats)
        assert stats["dispatches"] == len(self.groups)
        assert self.held == 0
        return outs

    def packed_off_the_main_thread(self, n_files):
        """Every file with traces packed once by pack_lanes, and no pack
        of any kind on the main thread."""
        main = threading.main_thread().ident
        return (sum(name == "pack_lanes" for name, _ in self.packs) == n_files
                and all(t != main for _, t in self.packs))

    def all_released(self):
        return ({id(g) for g in self.taken} == {id(g) for g in self.released}
                and all(not g.busy for g in self.taken))


class Taken:
    """A pool future that counts its input bytes out of the probe's bytes
    in flight once the main thread has its result.  It drops the future
    as it takes it, so that a failed one's traceback holds no cycle."""

    def __init__(self, fut, size, probe):
        self.fut, self.size, self.probe = fut, size, probe

    def result(self):
        fut, self.fut = self.fut, None
        try:
            return fut.result()
        finally:
            del fut
            with self.probe.lock:
                self.probe.held -= self.size


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("window", [1, 2, 3, len(DATAS) + 2])
def test_containers_and_groups_at_every_window(monkeypatch, want, window):
    B, outs, groups = want
    probe = Probe(monkeypatch, window)
    assert probe.run(DATAS, B) == outs
    assert probe.groups == groups
    assert probe.most_running == min(window, len(DATAS))
    assert probe.packed_off_the_main_thread(N_VIDEOS)
    # three clips go through the native extractor (one through Python)
    assert 1 <= probe.most_handles <= window + 1
    assert len(probe.handles) == 0
    assert probe.waiting == 0 and probe.most_waiting <= 2
    assert probe.all_released()


def test_bounds_hold_over_many_groups(monkeypatch, want):
    """The corpus three times over (12 files, 15-16 groups) at a window of 3:
    each copy's containers equal the first's, the bounds hold
    throughout."""
    B, outs, _ = want
    probe = Probe(monkeypatch, 3)
    got = probe.run(DATAS * 3, B)
    assert got == outs * 3
    assert len(probe.groups) >= 6
    assert probe.most_running == 3
    assert probe.packed_off_the_main_thread(3 * N_VIDEOS)
    assert 1 <= probe.most_handles <= 4
    assert len(probe.handles) == 0
    assert probe.waiting == 0 and probe.most_waiting <= 2
    assert probe.all_released()


@pytest.mark.parametrize("window", [1, 2])
def test_failure_propagates_and_releases_every_group(monkeypatch, want,
                                                    window):
    """The third of eight files in order (a copy of mbaff_b.mkv, one byte
    longer) fails to extract while the files before it are packed: Boom
    comes out of the call, every group taken is back in the ring, and the
    next call gives the containers."""
    B, outs, _ = want
    probe = Probe(monkeypatch, window)
    corpus = DATAS * 2
    order = sorted(range(len(corpus)), key=lambda i: -len(corpus[i]))
    probe.fail = corpus[order[2]] = bytes(corpus[order[2]]) + b"\0"
    with pytest.raises(Boom, match="extraction failed on purpose"):
        probe.run(corpus, B)
    assert probe.taken and probe.all_released()
    probe.fail = None
    assert probe.run(DATAS, B) == outs
    assert probe.all_released()
    assert len(probe.handles) == 0


@pytest.mark.parametrize("window", [2, len(DATAS) + 2])
def test_a_budget_under_every_file_runs_one_at_a_time(monkeypatch, want,
                                                      window):
    """EXTRACT_BYTES under the smallest file's size: exactly one file is
    in flight at a time, whatever the window, and the containers and
    groups stay as they are."""
    B, outs, groups = want
    probe = Probe(monkeypatch, window, budget=min(map(len, DATAS)) - 1)
    assert probe.run(DATAS, B) == outs
    assert probe.groups == groups
    assert probe.most_running == 1
    assert probe.most_held == max(map(len, DATAS))
    assert probe.packed_off_the_main_thread(N_VIDEOS)
    assert len(probe.handles) == 0 and probe.all_released()


def test_bytes_in_flight_stay_within_the_budget(monkeypatch, want):
    """A budget of the two largest files, a window past the corpus, over
    the corpus twice: the input bytes in flight never pass the budget, two
    files do run at once, and the containers and groups stay as they
    are."""
    B, outs, groups = want
    sizes = sorted(map(len, DATAS), reverse=True)
    budget = sizes[0] + sizes[1]
    probe = Probe(monkeypatch, 2 * len(DATAS) + 2, budget=budget)
    assert probe.run(DATAS, B) == outs
    assert probe.groups == groups
    assert probe.most_held <= budget
    assert probe.most_running == 2
    assert probe.run(DATAS * 2, B) == outs * 2
    assert probe.most_held <= budget
    assert probe.packed_off_the_main_thread(2 * N_VIDEOS)
    assert len(probe.handles) == 0 and probe.all_released()


@pytest.mark.parametrize("window", [1, 3])
def test_failing_pack_propagates_and_closes_every_handle(monkeypatch, want,
                                                        window):
    """The third of eight files in order (a copy of mbaff_b.mkv, one byte
    longer) extracts, then its pack raises Boom on its worker while the
    files before it are copied in: Boom comes out of the call as raised,
    every group taken is back in the ring, every extraction handle is
    closed, and the next call gives the containers."""
    B, outs, _ = want
    probe = Probe(monkeypatch, window)
    corpus = DATAS * 2
    order = sorted(range(len(corpus)), key=lambda i: -len(corpus[i]))
    probe.fail_pack = corpus[order[2]] = bytes(corpus[order[2]]) + b"\0"
    with pytest.raises(Boom, match="pack failed on purpose"):
        probe.run(corpus, B)
    assert probe.taken and probe.all_released()
    assert len(probe.handles) == 0
    probe.fail_pack = None
    assert probe.run(DATAS, B) == outs
    assert probe.all_released()
    assert len(probe.handles) == 0


def test_window_counts_the_cores_the_process_may_run_on():
    """EXTRACT_WINDOW is the size of the process's affinity mask, at least
    two, and the machine's count where the platform has no mask (a fresh
    interpreter, os.sched_getaffinity patched before each import)."""
    code = (
        "import importlib, os\n"
        "os.sched_getaffinity = lambda pid: {0, 3, 5}\n"
        "from avrecode_tpu_torch.parallel import pipeline\n"
        "print(pipeline.EXTRACT_WINDOW)\n"
        "os.sched_getaffinity = lambda pid: {7}\n"
        "print(importlib.reload(pipeline).EXTRACT_WINDOW)\n"
        "del os.sched_getaffinity\n"
        "print(importlib.reload(pipeline).EXTRACT_WINDOW,"
        " max(2, os.cpu_count()))\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    three, one, (none, cpus) = [ln.split() for ln in r.stdout.splitlines()]
    assert three == ["3"] and one == ["2"] and none == cpus


def test_first_native_calls_at_once_build_once(monkeypatch):
    """Eight threads ask for the native library at once in a process that
    has not loaded it (the corpus driver's workers, each extracting a
    file): the build runs once, and every thread sees the library."""
    path = native.build()
    builds = []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return path

    monkeypatch.setattr(native, "build", build)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    start = threading.Barrier(8)
    seen = []

    def first_call():
        start.wait()
        seen.append(native.available())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert seen == [True] * 8
    assert len(builds) == 1
