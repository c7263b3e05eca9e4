"""device_compress_corpus as a streaming pipeline, on the CPU
(avrecode_tpu_torch/parallel/pipeline.py with ops/lane_coder.py's
StreamingBatcher): several files extracted at once, each file's traces let
go once packed, each dispatch group read back before the next launches,
each container serialised once its rows are back.

Three clips (the CAVLC one through the Python parser) and a file with no
video, in groups of 100 rows: at every window the containers equal the JAX
package's device_compress_corpus and the port's codec.compress byte for
byte, and the groups fall where the batcher before streaming put them.
Along the way no more than the window's extractions run at once, no more
than the window plus one native extraction handles are alive, and no more
than two dispatched groups wait to be read back.  A failing extraction
comes out of the call as raised and leaves every group it took released."""

import os
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
    once, live native extraction handles (a WeakSet of every
    _XtractHandle made), dispatched groups not yet read back, and the
    groups taken from and given back to the ring.  `fail` names an input
    whose extraction raises Boom."""

    def __init__(self, monkeypatch, window):
        self.lock = threading.Lock()
        self.running = self.most_running = 0
        self.handles = weakref.WeakSet()
        self.most_handles = 0
        self.waiting = self.most_waiting = 0
        self.groups = []  # (index form, rows) of each dispatch
        self.taken, self.released = [], []
        self.fail = None
        monkeypatch.setattr(tpipe, "EXTRACT_WINDOW", window)
        monkeypatch.setattr(tlc, "GROUP_ROWS", ROWS)
        real_extract = tpipe.extract_traces

        def extract(data, **kw):
            with self.lock:
                self.running += 1
                self.most_running = max(self.most_running, self.running)
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

    def run(self, datas, B):
        stats = {}
        self.groups = []
        outs = tpipe.device_compress_corpus(
            datas, scope="gop", substream_bins=B, device="cpu", stats=stats)
        assert stats["dispatches"] == len(self.groups)
        return outs

    def all_released(self):
        return ({id(g) for g in self.taken} == {id(g) for g in self.released}
                and all(not g.busy for g in self.taken))


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("window", [1, 2, 3, len(DATAS) + 2])
def test_containers_and_groups_at_every_window(monkeypatch, want, window):
    B, outs, groups = want
    probe = Probe(monkeypatch, window)
    assert probe.run(DATAS, B) == outs
    assert probe.groups == groups
    assert probe.most_running == min(window, len(DATAS))
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
