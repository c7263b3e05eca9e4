"""The lane path's group staging on the CPU (ops/lane_coder.py: LaneBatcher,
_GroupRing, dispatch_group, collect_groups, GroupStreams), with the group
size set small so that a few clips make many groups.

Each file's lanes are packed straight into a dispatch group's buffer at the
batcher's row offset (native.lane_pack_into), or copied in where a file
crosses a group boundary, comes in the other upload form or was extracted
in Python; the rows dispatched must equal native.lane_pack's and the numpy
plain packers' (split_lanes_recs, pack_p1_idx), the groups must fall where
the batcher before group staging put them, and the envelopes cut by offset
from each group's one read-back must equal _make_envelope's.  Containers
must equal the JAX package's device_compress_corpus / device_compress and
the port's host codec, byte for byte."""

import os

import numpy as np
import pytest
import torch

from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.host.native import NativeTrace
from avrecode_tpu_torch.models.h264_model import _make_envelope
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline as tpipe

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "cavlc_ipp.mkv"]


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _cut(clip, sizes, foreign=False, scope="slice"):
    """NativeTraces over copies of the clip's first traces, cut to `sizes`
    bins; with foreign=True the first bin's p1 leaves the squash image (the
    u16 form)."""
    traces = native.extract(_read(clip), scope, want_slots=False)[3]
    out = [NativeTrace(t.recs[:n].copy(), t.limits)
           for t, n in zip(traces, sizes)]
    if foreign:
        r = out[0].recs
        r[0] = (r[0] & np.uint64((1 << 48) - 1)) | np.uint64(2 << 48)
    return out


def _old_groups(files, big):
    """(index form, rows) of each group the batcher made before group
    staging: rows appended in order, a group of exactly `big` rows as soon
    as so many wait, and the rows that wait dispatched first where a file
    of the other form comes."""
    groups, acc, form = [], 0, None
    for rows, index in files:
        if acc and index != form:
            groups.append((form, acc))
            acc = 0
        form = index
        acc += rows
        while acc >= big:
            groups.append((form, big))
            acc -= big
    if acc:
        groups.append((form, acc))
    return groups


def _dispatched_rows(pending):
    """The rows every group uploaded, in global order: (p1 row, bitw row,
    len) numpy, p1 in its group's form."""
    rows = []
    for n, _, _, _, _, (p1, bitw, lens) in pending:
        p1, bitw, lens = p1.numpy(), bitw.numpy(), lens.numpy()
        rows += [(p1[r], bitw[r], lens[r]) for r in range(n)]
    return rows


B = 256
BIG = 10
# (clip, bins of each trace, foreign p1) in append order; rows at B = 256:
FILES = [
    ("rt_ctr.mkv", [1280, 700], False),  # 8 rows, packed at row 0
    ("mbaff_b.mkv", [600], False),  # 3, crosses the boundary at 10
    ("cavlc_ipp.mkv", [300, 10], True),  # u16 while an index row waits
    ("rt_ctr.avi", [6400], False),  # 25 rows: larger than a group
    ("sep.264", [900], True),  # u16 packed at row 5 of an index group
    ("mono.264", [500, 100], False),  # index while u16 rows wait
    ("mbaff_b.mkv", [1200, 300], False),  # fills the group exactly
    ("rt_ctr.mkv", [400], True),  # u16 into an empty index group
    ("mono.264", [256, 257, 0], False),  # a lane of exactly B, an empty one
]


@pytest.fixture(scope="module")
def batched():
    files = [_cut(c, sizes, foreign) for c, sizes, foreign in FILES]
    bat = tlc.LaneBatcher("cpu", BIG)
    placed = [bat.add_traces(tr, B) for tr in files]
    return files, bat, placed, bat.finish()


def test_groups_fall_where_they_did(batched):
    files, bat, placed, _ = batched
    forms = [tlc.index_form(tlc.pack_lanes(tr, B)[0]) for tr in files]
    assert forms == [not foreign for _, _, foreign in FILES]
    rows = [hi - lo for (lo, hi), _ in placed]
    assert rows == [native.lane_rows(tr, B) for tr in files]
    assert [(h[5][0].dtype == torch.uint8, h[0]) for h in bat.pending] == (
        _old_groups(list(zip(rows, forms)), BIG))
    assert placed[0][0][0] == 0 and placed[-1][0][1] == bat.rows
    assert all(a[0][1] == b[0][0] for a, b in zip(placed, placed[1:]))


def test_rows_equal_the_native_and_numpy_packers(batched):
    files, bat, placed, _ = batched
    rows = _dispatched_rows(bat.pending)
    assert len(rows) == bat.rows
    for tr, ((lo, hi), spans) in zip(files, placed):
        p1, bitw, lens, nspans = native.lane_pack(tr, B, B)
        u16, bitw2, lens2, spans2 = tlc.split_lanes_recs(tr, B)
        pk, ok = tlc.pack_p1_idx(u16, lens2)
        np.testing.assert_array_equal(bitw, bitw2)
        np.testing.assert_array_equal(lens, lens2)
        assert spans == nspans == spans2
        assert ok == tlc.index_form(p1)
        np.testing.assert_array_equal(p1, pk if ok else u16)
        got = rows[lo:hi]
        np.testing.assert_array_equal(np.stack([r[0] for r in got]), p1)
        np.testing.assert_array_equal(np.stack([r[1] for r in got]), bitw)
        np.testing.assert_array_equal([r[2] for r in got], lens)


def test_envelopes_equal_each_files_own_call(batched):
    files, _, placed, got = batched
    for tr, ((lo, _), spans) in zip(files, placed):
        p1, bitw, lens, _ = tlc.pack_lanes(tr, B)
        streams = tlc.lane_streams_device_compact(p1, bitw, lens, "cpu")
        want = [_make_envelope(streams[a:b]) for a, b in spans]
        assert [got.envelope(lo + a, lo + b) for a, b in spans] == want
        assert tlc.encode_traces_lanes(tr, B, device="cpu") == want


def test_python_traces_are_copied_into_the_group():
    """Python-extracted traces go through pack_lanes' numpy path into the
    group's rows, beside native ones packed in place."""
    data = _read("rt_ctr.mkv")
    py = tpipe.extract_traces(data, use_native=False, scope="slice")[3][:2]
    nat = _cut("rt_ctr.mkv", [len(t) for t in py])
    bat = tlc.LaneBatcher("cpu", 7)
    (lo0, hi0), spans = bat.add_traces(nat, B)
    (lo1, hi1), spans1 = bat.add_traces(py, B)
    got = bat.finish()
    assert spans == spans1 and hi0 - lo0 == hi1 - lo1
    assert ([got.envelope(lo0 + a, lo0 + b) for a, b in spans]
            == [got.envelope(lo1 + a, lo1 + b) for a, b in spans])
    rows = _dispatched_rows(bat.pending)
    for (a0, b0, c0), (a1, b1, c1) in zip(rows[lo0:hi0], rows[lo1:hi1]):
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(b0, b1)
        assert c0 == c1


@pytest.mark.parametrize("seed", [0, 1])
def test_envelopes_by_offset_equal_make_envelope(seed):
    """GroupStreams over groups of random stream lengths (empty streams,
    lengths past 127 and 16,383, which take two- and three-byte varints),
    envelopes over lanes that cross groups, equal _make_envelope's."""
    rng = np.random.default_rng(seed)
    groups, streams = [], []
    for n in (5, 1, 0, 9, 3):
        nb = rng.choice([0, 1, 127, 128, 300, 16383, 16384], n).astype(
            np.int32)
        w = int(nb.max(initial=0))
        flat = rng.integers(0, 256, n * w, dtype=np.uint8).tobytes()
        groups.append((nb, w, flat))
        streams += tlc.cut_streams(nb, w, flat)
    got = tlc.GroupStreams(groups)
    L = len(streams)
    cuts = sorted(set([0, L] + rng.integers(0, L, 6).tolist()))
    for lo, hi in [(a, b) for a in cuts for b in cuts if a <= b]:
        assert got.envelope(lo, hi) == _make_envelope(streams[lo:hi])


def test_group_ring_on_the_cpu_is_fresh_and_checks_b():
    a = tlc._groups.take(True, 512, 4, torch.device("cpu"))
    b = tlc._groups.take(True, 512, 4, torch.device("cpu"))
    assert a.p1.data_ptr() != b.p1.data_ptr() and not a.p1.is_pinned()
    assert a.p1.shape == (4, 768) and a.bitw.shape == (4, 16)
    assert a.np[0].ctypes.data == a.p1.data_ptr()
    with pytest.raises(ValueError, match="carry"):
        tlc._groups.take(False, tlc.MAX_B + 256, 1, torch.device("cpu"))


@pytest.mark.parametrize("hold", [True, False])
def test_group_put_copies_rows_either_way(monkeypatch, hold):
    """_Group.put writes each array at rows r0 on and nothing else, held
    under HOLD_GIL_BYTES (memoryviews) or by numpy above it, from strided
    sources and other integer types."""
    monkeypatch.setattr(tlc, "HOLD_GIL_BYTES", 1 << 40 if hold else 0)
    rng = np.random.default_rng(7)
    g = tlc._groups.take(True, 512, 9, torch.device("cpu"))
    for a in g.np:
        a[...] = 0
    p1 = rng.integers(0, 256, (6, 768), dtype=np.uint8)[::2]
    bitw = rng.integers(-2**31, 2**31, (3, 16), dtype=np.int64)
    lens = np.array([512, 1, 0], np.int64)
    g.put(4, p1, bitw, lens)
    for dst, src in zip(g.np, (p1, bitw, lens)):
        np.testing.assert_array_equal(dst[4:7], src)
        assert not dst[:4].any() and not dst[7:].any()


def test_lane_pack_into_checks_its_destinations():
    tr = _cut("rt_ctr.mkv", [600])
    L = native.lane_rows(tr, B)
    good = [np.empty((L, 3 * B // 2), np.uint8), np.empty((L, B), np.uint16),
            np.empty((L, B // 32), np.int32), np.empty(L, np.int32)]
    assert native.lane_pack_into(tr, B, B, *good)[0] == 1
    for k, bad in enumerate([np.empty((L + 1, 3 * B // 2), np.uint8),
                             np.empty((L, B), np.int16),
                             np.empty((L, B // 16), np.int32)[:, ::2],
                             np.empty(L, np.int64)]):
        args = list(good)
        args[k] = bad
        with pytest.raises(ValueError, match="lane_pack_into"):
            native.lane_pack_into(tr, B, B, *args)


def _counting(monkeypatch):
    """Every LaneBatcher's dispatched groups, (index form, rows)."""
    groups = []
    real = tlc.dispatch_group

    def spy(group, n, dev, bits_per_byte=4):
        groups.append((group.index, n))
        return real(group, n, dev, bits_per_byte)

    monkeypatch.setattr(tlc, "dispatch_group", spy)
    return groups


@pytest.mark.parametrize("B", [1024, 1000])
def test_corpus_containers_equal_jax_and_host(monkeypatch, B):
    """device_compress_corpus with groups of 100 rows over three clips (a
    file larger than a group, files across boundaries), one of them
    extracted in Python, and a file with no video: containers equal to the
    JAX corpus pipeline's and to codec.compress, dispatches as before."""
    datas = [_read(c) for c in CLIPS] + [b"not a video at all"]
    real = tpipe.extract_traces

    def extract(data, **kw):  # the CAVLC clip through the Python parser
        if data == datas[2]:
            kw["use_native"] = False
        return real(data, **kw)

    monkeypatch.setattr(tpipe, "extract_traces", extract)
    monkeypatch.setattr(tlc, "GROUP_ROWS", 100)
    groups = _counting(monkeypatch)
    stats = {}
    outs = tpipe.device_compress_corpus(datas, scope="gop", substream_bins=B,
                                        device="cpu", stats=stats)
    assert outs == jpipe.device_compress_corpus(datas, scope="gop",
                                                substream_bins=B)
    assert outs == [codec.compress(d, scope="gop", substream_bins=B)
                    for d in datas]
    order = sorted(range(len(datas)), key=lambda i: -len(datas[i]))
    files = []
    for i in order:
        traces = real(datas[i], scope="gop", want_slots=False)[3]
        if traces:
            files.append((native.lane_rows(traces, B), True))
    assert groups == _old_groups(files, 100)
    assert stats["dispatches"] == len(groups) > 3


def test_device_compress_over_several_groups(monkeypatch):
    """The single-file lane path with groups of 64 rows: mbaff_b.mkv's 219
    lanes at B = 1024 go in four groups; the container equals the JAX
    device_compress and codec.compress."""
    monkeypatch.setattr(tlc, "GROUP_ROWS", 64)
    groups = _counting(monkeypatch)
    data = _read("mbaff_b.mkv")
    out = tpipe.device_compress(data, scope="gop", substream_bins=1024,
                                device="cpu")
    assert groups == [(True, 64)] * 3 + [(True, 27)]
    assert out == jpipe.device_compress(data, scope="gop",
                                        substream_bins=1024)
    assert out == codec.compress(data, scope="gop", substream_bins=1024)


@pytest.mark.parametrize("foreign", [False, True])
def test_numpy_rows_dispatch_in_groups(monkeypatch, foreign):
    """Numpy rows, as lane_streams_device_compact and the tools hand them
    in, go up through a LaneBatcher's group buffers (add) in groups of
    GROUP_ROWS: with groups of 16 rows, in either form, the streams equal
    the one-group call's and the handles hold the rows given."""
    tr = _cut("rt_ctr.mkv", [1280, 700, 5000], foreign)
    p1, bitw, lens, _ = tlc.pack_lanes(tr, B)
    assert tlc.index_form(p1) != foreign
    want = tlc.lane_streams_device_compact(p1, bitw, lens, "cpu")
    monkeypatch.setattr(tlc, "GROUP_ROWS", 16)
    bat = tlc.LaneBatcher("cpu")
    assert bat.add(p1, bitw, lens) == (0, 27)
    pending = bat.dispatch()
    assert [h[0] for h in pending] == [16, 11]
    got = _dispatched_rows(pending)
    np.testing.assert_array_equal(np.stack([r[0] for r in got]), p1)
    np.testing.assert_array_equal(np.stack([r[1] for r in got]), bitw)
    assert tlc.lane_collect(pending) == want
