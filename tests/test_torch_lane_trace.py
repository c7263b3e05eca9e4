"""The lane form of the gop-scope extraction (native.extract_lanes, the
library's avtpu_xopen_lane): one uint16 code a bin, the squash index of
its p1 and the bin, where native.extract keeps an 8-byte record.

The lane form must give what the lane coder reads of the 8-byte form
exactly: the same parameter sets and blocks, the same traces' bits and p1,
and the same packed rows from the native packer (avtpu_lane_pack_codes
against avtpu_lane_pack) and from the lane batcher, which puts the rows in
the same groups.  The lane main path counts 2 bytes of records a bin
(stats trace_bytes), the est path 8."""

import os

import numpy as np
import pytest

from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.host.native import LaneTrace, NativeTrace
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline as tpipe

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
CAMERA = os.path.join(ROOT, "benchmark", "clips", "camera")
# the clips tests/test_torch_host.py extracts in the gop scope
CLIPS = ["rt_ctr.mkv", "rt_ctr.ts", "rt_ctr.avi", "rt_ctr.flv", "rt_ctr.mpg",
         "mbaff_b.mkv"]
SPLICED = "cam_gop1.264+cam_gop2.264"


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


def _read(name):
    if name == SPLICED:  # two committed 1080p GOPs, one Annex B stream
        return b"".join(open(os.path.join(CAMERA, n), "rb").read()
                        for n in name.split("+"))
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _plain_blocks(blocks, traces):
    """Blocks with each trace replaced by its index in `traces`."""
    index = {id(t): i for i, t in enumerate(traces)}
    return [tuple(index.get(id(x), x) if not isinstance(x, (bytes, int, list))
                  else x for x in b) for b in blocks]


@pytest.fixture(scope="module", params=CLIPS + [SPLICED])
def both(request):
    """(clip, native.extract's result without the slot remap, the lane
    form's)."""
    data = _read(request.param)
    return (request.param, native.extract(data, "gop", threads=0,
                                          want_slots=False),
            native.extract_lanes(data))


def test_lane_form_equals_the_records(both):
    """Parameter sets, blocks, trace count and lengths, bits and p1 equal
    the 8-byte form's exactly; every code's bits 13-15 are zero."""
    _, recs, lanes = both
    assert lanes[0] == recs[0] and lanes[1] == recs[1]
    assert _plain_blocks(lanes[2], lanes[3]) == _plain_blocks(recs[2],
                                                              recs[3])
    assert len(lanes[3]) == len(recs[3]) > 0
    for lt, nt in zip(lanes[3], recs[3]):
        assert isinstance(lt, LaneTrace) and len(lt) == len(nt)
        assert lt.codes.dtype == np.uint16
        assert not (lt.codes >> 13).any()
        np.testing.assert_array_equal(lt.bits, nt.bits)
        np.testing.assert_array_equal(lt.p1s, nt.p1s)
        assert lt.nbytes == 2 * len(lt) and nt.nbytes == 8 * len(nt)


@pytest.mark.parametrize("B", [16384, 300])
def test_lane_pack_equals_the_records(both, B):
    """native.lane_pack of the lane form: byte for byte the 8-byte form's
    rows (the index form, bit words and lens) and spans; B = 300 cuts
    lanes across trace ends."""
    _, recs, lanes = both
    Bp = -(-B // tlc.CHUNK) * tlc.CHUNK
    want = native.lane_pack(recs[3], B, Bp)
    got = native.lane_pack(lanes[3], B, Bp)
    assert got[0].dtype == want[0].dtype == np.uint8
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def _foreign(clip, n):
    """A NativeTrace of the clip's first n bins with the first p1 off the
    squash image: the batcher puts it in a u16 group."""
    t = native.extract(_read(clip), "slice", want_slots=False)[3][0]
    r = t.recs[:n].copy()
    r[0] = (r[0] & np.uint64((1 << 48) - 1)) | np.uint64(2 << 48)
    return [NativeTrace(r, t.limits)]


def _dispatched(bat):
    """Each group's (form, rows) and its uploaded rows, numpy."""
    out = []
    for n, _, _, _, _, (p1, bitw, lens) in bat.pending:
        out.append((p1.dtype, n, p1.numpy()[:n], bitw.numpy()[:n],
                    lens.numpy()[:n]))
    return out


@pytest.mark.parametrize("B, big, first", [
    (16384, 8, None),       # into an empty index group
    (300, 40, None),        # lanes cut across trace ends
    (300, 40, 1000),        # after rows of the u16 form wait
    (300, 6, 1000),         # after u16 rows, the file larger than a group
    (16384, 8, 300),
])
def test_batcher_rows_equal_the_records(both, B, big, first, monkeypatch):
    """LaneBatcher.add_traces of the lane form: the same groups, of the
    same forms, holding byte for byte the same rows and lens as of the
    8-byte form, and the same placements, also where a u16 group is being
    filled when the file comes.  The groups are uploaded and not coded
    (the rows are what is compared)."""
    _, recs, lanes = both
    monkeypatch.setattr(tlc, "_launch", lambda n, lens, prob, Bp, bpb: (
        n, lens, None, None, None, prob))
    got = []
    for traces in (recs[3], lanes[3]):
        bat = tlc.LaneBatcher("cpu", big)
        if first is not None:
            bat.add_traces(_foreign("rt_ctr.mkv", first), B)
            assert not bat.group.index
        placed = bat.add_traces(traces, B)
        bat.dispatch()
        got.append((placed, _dispatched(bat)))
    (want_placed, want), (placed, groups) = got
    assert placed == want_placed
    assert len(groups) == len(want)
    for g, w in zip(groups, want):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(a, b)


def test_absent_fields_raise(both):
    """recs, slots and pcabs are not kept in the lane form: asking raises
    and says why; the native packers still take the traces."""
    _, _, lanes = both
    t = lanes[3][0]
    for name in ("recs", "slots", "pcabs"):
        with pytest.raises(AttributeError, match="lane form"):
            getattr(t, name)
    assert not hasattr(t, "recs32")
    assert native.lane_form(lanes[3]) and native.native_traces(lanes[3])


def test_mixed_forms_refused():
    """The packer takes LaneTraces all together or none: one among
    NativeTraces has no records to pack."""
    data = _read("rt_ctr.mkv")
    mixed = native.extract(data, "gop", want_slots=False)[3] + (
        native.extract_lanes(data)[3])
    with pytest.raises(AttributeError, match="lane form"):
        native.lane_pack(mixed, 300, 512)


@pytest.mark.parametrize("scope, bins, per_bin", [
    ("gop", 4096, 2),   # the lane main path: the lane form
    ("slice", 4096, 8),  # the slice scope keeps its records
    ("gop", 0, 8),      # the est path reads the slots
])
def test_trace_bytes_per_bin(scope, bins, per_bin):
    """stats trace_bytes over stats bins: 2 on the lane path in the gop
    scope (device_compress and device_compress_corpus), 8 where the
    records are kept; the containers are the host codec's."""
    from avrecode_tpu_torch import codec

    datas = [_read(c) for c in ("rt_ctr.mkv", "mbaff_b.mkv")]
    stats = {}
    out = tpipe.device_compress(datas[0], scope=scope, substream_bins=bins,
                                device="cpu", stats=stats)
    want = (codec.compress(datas[0], scope=scope, substream_bins=bins)
            if bins else native.compress(datas[0], scope=scope))
    assert out == want
    assert stats["bins"] > 0
    assert stats["trace_bytes"] == per_bin * stats["bins"]
    if bins:
        stats = {}
        outs = tpipe.device_compress_corpus(
            datas, scope=scope, substream_bins=bins, device="cpu",
            stats=stats)
        assert outs == [codec.compress(d, scope=scope, substream_bins=bins)
                        for d in datas]
        assert stats["trace_bytes"] == per_bin * stats["bins"] > 0
