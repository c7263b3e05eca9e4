"""Tests of the port that need an NVIDIA GPU (marker `cuda`; they skip
where there is none).  This file imports neither JAX nor the JAX package, so it also
runs where only the port's dependencies are installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

The CUDA kernels must equal their plain torch versions exactly (integer
arithmetic, tolerance zero), and the main paths must go through them."""

import os

import numpy as np
import pytest
import torch

from avrecode_tpu_torch import codec, spans
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.models.h264_model import _make_envelope
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.ops import lane_decoder as tld
from avrecode_tpu_torch.parallel.pipeline import (
    device_compress, device_decompress, extract_traces, make_mesh,
    multichip_step)
from chip_smoke import (
    EST_CASES, EST_SWEEP, LONE_LANE, LONE_UNIT, STREAM_CASES,
    lone_lane_vs_host, one_long_lane, streams_diff)
from chip_smoke import squash_lanes
from chip_smoke import decode_problem as _decode_problem
from chip_smoke import est_problem as _est_problem
from chip_smoke import lanes as _problem

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# lane counts that are no multiple of a warp's 16 lanes, widths that are no
# multiple of the kernel's 128-bin tile; chip_smoke.lanes puts lens of 0, 1,
# 127, 128, 129 (and the 8-bin group edges) on the first lanes
@pytest.mark.parametrize("kind, L, B", [
    ("random", 5, 256), ("random", 300, 1024), ("carry", 300, 4096),
    ("random", 130, 16384), ("random", 4, 32768),
    ("random", 1, 32), ("random", 33, 96), ("random", 70, 160),
    ("random", 31, 4128), ("carry", 97, 1184), ("random", 64, 128),
    ("random", 17, 256), ("zero", 40, 512),
])
def test_kernel_matches_plain(cuda, kind, L, B):
    prob = tlc.from_numpy_problem(*_problem(kind, L, B, seed=L + B), cuda)
    before = tlc.lane_encode.launches
    got = tlc.lane_encode(*prob)
    torch.cuda.synchronize()
    assert tlc.lane_encode.launches == before + 1
    for a, b in zip(got, tlc.lane_encode_plain(*prob)):
        assert a.device.type == "cuda" and a.dtype == torch.int32
        assert torch.equal(a, b)


# chip_smoke's cases of the fused kernel: carry stress, runs of 0xFF longer
# than the kernel's ring with a carry through them into position 0, lens of
# 0, 1 and B, lane counts off a lane group's 32 (1, 31, 33, 8,191), off the
# index kernel's two block shapes and where it changes from one to the
# other (63, 64, 65, 127, 129, 4,224, 4,225, 4,351, 8,193), one long lane
# in every 64 among short ones, lanes that end on a tile edge, p1 at its
# ends, bounds that lanes run past
@pytest.mark.parametrize("kind, L, B, cut, bits_per_byte", STREAM_CASES)
def test_streams_kernel_matches_plain(cuda, kind, L, B, cut, bits_per_byte):
    p1u16, bitw, lens = _problem(kind, L, B, seed=L + B)
    if cut is not None:
        lens = np.minimum(lens, cut)
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, cuda)
    M = tlc.max_bytes(B, bits_per_byte)
    before = tlc.lane_encode_streams.launches
    got = tlc.lane_encode_streams(*prob, M)
    torch.cuda.synchronize()
    assert tlc.lane_encode_streams.launches == before + 1
    assert got[0].dtype == torch.uint8 and got[0].shape == (L, M)
    assert all(t.device.type == "cuda" for t in got)
    ref = tlc.lane_encode_streams_plain(*prob, M)
    assert streams_diff(got, ref, M) == 0
    out, nb, tot = (t.cpu().numpy() for t in got)
    host = tlc.finalize_lanes(
        *(t.cpu().numpy() for t in tlc.lane_encode(*prob)), lens)
    for l in np.flatnonzero(tot <= M):
        assert bytes(out[l, : nb[l]]) == host[l]


def test_streams_kernel_lone_lane(cuda):
    """One lane of the most bins a lane takes, held to the host encoder."""
    assert lone_lane_vs_host(cuda, LONE_LANE, 5) == 0


# the same cases in the index form: p1 on the squash table's image (every
# index among the valid bins of the larger problems), padding index 0
@pytest.mark.parametrize("kind, L, B, cut, bits_per_byte", STREAM_CASES)
def test_streams_idx_kernel_matches_plain(cuda, kind, L, B, cut,
                                          bits_per_byte):
    prob = tlc.from_numpy_problem(
        *squash_lanes(kind, L, B, seed=L + B, cut=cut), cuda)
    M = tlc.max_bytes(B, bits_per_byte)
    before = tlc.lane_encode_streams_idx.launches
    got = tlc.lane_encode_streams_idx(*prob, M)
    torch.cuda.synchronize()
    assert tlc.lane_encode_streams_idx.launches == before + 1
    assert got[0].shape == (L, M) and all(t.is_cuda for t in got)
    assert streams_diff(got, tlc.lane_encode_streams_idx_plain(*prob, M),
                        M) == 0
    p1 = tlc.unpack_p1_idx(prob[0])
    assert torch.equal(p1, tlc.unpack_p1_idx_plain(prob[0]))
    assert streams_diff(got, tlc.lane_encode_streams(p1, *prob[1:], M),
                        M) == 0


def test_streams_idx_kernel_lone_lane(cuda):
    assert lone_lane_vs_host(cuda, LONE_LANE, 6, index=True) == 0


def test_idx_overflow_path_unpacks_on_the_card(cuda):
    pk, bitw, lens = squash_lanes("carry", 40, 2048, seed=9)
    host = tlc.lane_streams_device_compact(pk, bitw, lens, "cpu",
                                           bits_per_byte=1)
    counts = {n: getattr(tlc, n).launches for n in (
        "lane_encode_streams_idx", "unpack_p1_idx", "lane_encode")}
    dense = tlc.lane_streams_device_compact(pk, bitw, lens, cuda,
                                            bits_per_byte=1000)
    assert dense == host
    assert {n: getattr(tlc, n).launches - c for n, c in counts.items()} == {
        "lane_encode_streams_idx": 1, "unpack_p1_idx": 1, "lane_encode": 1}


def test_streams_idx_kernel_rejects_misaligned_indices(cuda):
    pk, bitw, lens = tlc.from_numpy_problem(
        *squash_lanes("random", 2, 64, seed=1), cuda)
    flat = torch.zeros(2 * 96 + 4, dtype=torch.uint8, device=cuda)
    view = flat[4:].view(2, 96)  # contiguous, four bytes off the boundary
    with pytest.raises(ValueError, match="16-byte"):
        tlc.lane_encode_streams_idx(view, bitw, lens, 24)
    with pytest.raises(ValueError, match="4-byte"):
        tlc.unpack_p1_idx(flat[1:97].view(1, 96))


def test_kernel_streams_and_overflow_path(cuda):
    p1u16, bitw, lens = _problem("carry", 40, 2048, seed=9)
    host = tlc.lane_streams_device_compact(p1u16, bitw, lens, "cpu",
                                           bits_per_byte=1)
    fused, unfused = tlc.lane_encode_streams.launches, tlc.lane_encode.launches
    assert tlc.lane_streams_device_compact(p1u16, bitw, lens, cuda,
                                           bits_per_byte=1) == host
    assert tlc.lane_encode_streams.launches == fused + 1
    assert tlc.lane_encode.launches == unfused
    before = tlc.lane_collect.overflows
    dense = tlc.lane_streams_device_compact(p1u16, bitw, lens, cuda,
                                            bits_per_byte=1000)
    assert tlc.lane_collect.overflows == before + 1
    assert tlc.lane_encode.launches == unfused + 1  # the group, coded again
    assert dense == host


def test_main_path_launches_kernel(cuda):
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    before = tlc.lane_encode_streams_idx.launches
    u16, unfused = tlc.lane_encode_streams.launches, tlc.lane_encode.launches
    out = device_compress(data, scope="gop", substream_bins=4096, device=cuda)
    # native traces' p1 lie on the squash grid: the index form
    assert tlc.lane_encode_streams_idx.launches == before + 1
    assert tlc.lane_encode_streams.launches == u16
    assert tlc.lane_encode.launches == unfused
    assert out == codec.compress(data, scope="gop", substream_bins=4096)


@pytest.mark.parametrize("ring", [1, 3])
def test_staging_buffers_are_reused_safely(cuda, monkeypatch, ring):
    """Three groups of different contents uploaded through _upload (the
    staging ring that the est path's and the decoder's uploads take) and
    launched back to back, and two more on streams of their own, all
    through `ring` small pinned staging buffers that every upload rewrites
    many times: each group's streams equal the CPU route's."""
    monkeypatch.setattr(tlc, "STAGE_RING", ring)
    monkeypatch.setattr(tlc, "STAGE_BYTES", 1 << 16)
    monkeypatch.setattr(tlc, "_staging", tlc._Staging())
    groups = [_problem(kind, 300, 2048, seed=s)
              for s, kind in enumerate(["random", "carry", "random", "carry",
                                        "random"])]
    want = [tlc.lane_streams_device_compact(*g, "cpu", bits_per_byte=1)
            for g in groups]
    pending = [_staged_dispatch(g, cuda) for g in groups[:3]]
    streams = [torch.cuda.Stream(cuda) for _ in groups[3:]]
    for g, s in zip(groups[3:], streams):
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            pending.append(_staged_dispatch(g, cuda))
    assert len(tlc._staging.ring) == ring
    assert tlc._staging.turn >= 5 * (300 * 2048 * 2 >> 16)
    for k, (handles, s) in enumerate(zip(pending, [None] * 3 + streams)):
        if s is None:
            got = tlc.lane_collect(handles)
        else:
            with torch.cuda.stream(s):
                got = tlc.lane_collect(handles)
        assert got == want[k], f"group {k}"


def _staged_dispatch(g, dev):
    """One numpy lane group uploaded through _Staging (_upload) and
    launched once (bits_per_byte 1): its pending handles, as lane_collect
    takes them."""
    prob = tuple(tlc._upload(a, dev) for a in g)
    return [tlc._launch(len(g[2]), prob[2], prob, tlc.lane_bins(g[0]), 1)]


def test_dispatch_does_not_wait_for_the_device(cuda):
    """No host sync between pack, upload and launch on the lane main path:
    with the ring's buffers pinned and free, dispatch_traces_lanes returns
    while a long sleep kernel holds the stream, and its collect half gives
    the envelopes of the whole call, which equal the CPU route's."""
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "mbaff_b.mkv"), "rb").read()
    traces = extract_traces(data, scope="gop", want_slots=False)[3]
    for _ in range(tlc.GROUP_RING):  # build, pin the ring's buffers
        want = tlc.encode_traces_lanes(traces, 4096, cuda)
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(int(2e9))  # about a second of device time
    done.record()
    handle = tlc.dispatch_traces_lanes(traces, 4096, cuda)
    assert not done.query()  # the dispatch came back while the card slept
    assert tlc.collect_traces_lanes(handle) == want
    assert want == tlc.encode_traces_lanes(traces, 4096, "cpu")


@pytest.mark.parametrize("ring", [1, 3])
def test_group_buffers_are_reused_safely(cuda, monkeypatch, ring):
    """Groups of different contents filled into a ring of `ring` pinned
    group buffers that the fills come round to again, while a sleep kernel
    keeps every upload waiting: three through a LaneBatcher on the current
    stream, one each through batchers on two streams of their own.  Every
    lane's envelope equals the CPU route's."""
    monkeypatch.setattr(tlc, "GROUP_RING", ring)
    monkeypatch.setattr(tlc, "_groups", tlc._GroupRing())
    groups = [_problem(kind, 300, 2048, seed=s)
              for s, kind in enumerate(["random", "carry", "random", "carry",
                                        "random"])]
    want = [tlc.lane_streams_device_compact(*g, "cpu", bits_per_byte=1)
            for g in groups]
    torch.cuda._sleep(int(2e9))  # about a second of device time
    bat = tlc.LaneBatcher(cuda, 300)
    runs = [(bat, [bat.add(*g) for g in groups[:3]], want[:3], None)]
    assert len(bat.pending) == 3
    for g, w in zip(groups[3:], want[3:]):
        s = torch.cuda.Stream(cuda)
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            b = tlc.LaneBatcher(cuda, 300)
            runs.append((b, [b.add(*g)], [w], s))
    assert [len(r) for r in tlc._groups.rings.values()] == [ring]
    for k, (b, placed, ws, s) in enumerate(runs):
        with torch.cuda.stream(s):
            got = b.finish()
        for (lo, hi), w in zip(placed, ws):
            assert [got.envelope(l, l + 1) for l in range(lo, hi)] == [
                _make_envelope([x]) for x in w], f"batcher {k}"


def test_group_dispatch_does_not_wait_for_the_device(cuda):
    """No host sync between a batcher's pack and its launch: with the
    ring's buffers pinned and free, a group dispatched while the card
    sleeps comes back before the sleep ends."""
    p1u16, bitw, lens = _problem("random", 64, 1024, seed=4)
    for _ in range(tlc.GROUP_RING):  # build, pin the ring's buffers
        warm = tlc.LaneBatcher(cuda, 64)
        warm.add(p1u16, bitw, lens)
        warm.finish()
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(int(2e9))  # about a second of device time
    done.record()
    bat = tlc.LaneBatcher(cuda, 64)
    bat.add(p1u16, bitw, lens)
    assert len(bat.pending) == 1
    assert not done.query()  # the dispatch came back while the card slept
    got = bat.finish()
    assert [got.envelope(l, l + 1) for l in range(64)] == [
        _make_envelope([x]) for x in tlc.lane_streams_device_compact(
            p1u16, bitw, lens, "cpu")]


def test_streams_kernel_rejects_misaligned_p1(cuda):
    p1u16, bitw, lens = tlc.from_numpy_problem(
        *_problem("random", 2, 64, seed=1), cuda)
    flat = torch.zeros(2 * 64 + 1, dtype=torch.uint16, device=cuda)
    view = flat[1:].view(2, 64)  # contiguous, two bytes off the boundary
    with pytest.raises(ValueError, match="16-byte"):
        tlc.lane_encode_streams(view, bitw, lens, 24)


def test_lane_kernel_rejects_misaligned_p1(cuda):
    p1u16, bitw, lens = tlc.from_numpy_problem(
        *_problem("random", 2, 64, seed=1), cuda)
    flat = torch.zeros(2 * 64 + 1, dtype=torch.uint16, device=cuda)
    view = flat[1:].view(2, 64)  # contiguous, two bytes off the boundary
    with pytest.raises(ValueError, match="16-byte"):
        tlc.lane_encode(view, bitw, lens)


# the first est kernel's cases, then chip_smoke's: slot counts on both sides
# of the shared-memory budget, T under and off the 32-bin tile, valid bins
# only in a tile's tail, one slot hit by every bin, slot and class runs
# across tile edges and ring wraps, several traces a block, counters at
# every limit
@pytest.mark.parametrize("kind, S, T, NS", [
    ("random", 33, 1024, 300), ("skew", 8, 2048, 64), ("holes", 16, 1024, 128),
    ("random", 4, 512, 4096), *EST_CASES[4:], EST_SWEEP,
])
def test_est_kernel_matches_plain(cuda, kind, S, T, NS):
    prob = tec.from_numpy_traces(*_est_problem(kind, S, T, NS, seed=S + T), cuda)
    before = tec.est_encode.launches
    got = tec.est_encode(*prob)
    torch.cuda.synchronize()
    assert tec.est_encode.launches == before + 1
    for a, b in zip(got, tec.est_encode_plain(*prob)):
        assert a.device.type == "cuda" and a.dtype == torch.int32
        assert torch.equal(a, b)


def test_est_gop_traces_on_the_stage_warps(cuda):
    """The archive cell's shape at test size: GOP-long traces (the
    benchmark's three small test GOPs at gop scope, native traces with
    slot tables) through encode_traces_est as one group: every trace coded
    by the stage-warp kernel (est_stage_traces), and the kernel's outputs
    on the packed problem equal est_encode_plain's."""
    if not native.available():
        pytest.skip("native library not built")
    traces = []
    for i in (1, 2, 3):
        path = os.path.join(os.path.dirname(__file__), "..", "benchmark",
                            "tests", "data", f"gop{i}.264")
        with open(path, "rb") as f:
            traces += native.extract(f.read(), "gop", want_slots=True)[3]
    stats = {}
    with spans.call("est", stats):
        streams = tec.encode_traces_est(traces, cuda)
    assert stats["est_stage_traces"] == stats["est_traces"] == len(traces)
    S, T = len(traces), max(map(len, traces))
    NS = max(len(t.limits) for t in traces)
    prob = tec.from_numpy_traces(*tec.pack_rows(traces, S, T, NS), cuda)
    got = tec.est_encode(*prob)
    want = tec.est_encode_plain(*prob)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert streams == tec.finalize_streams(*(t.cpu() for t in want))


def test_broadcast_gop_on_the_main_path(cuda):
    """A 1080i MBAFF GOP of the broadcast configuration
    (benchmark/clips/broadcast/bc_gop1.264, field pairs nearly throughout)
    through the lane main path at the configuration's 16,384 bins a lane:
    the index launcher runs, and the container equals the host codec's."""
    if not native.available():
        pytest.skip("native library not built")
    path = os.path.join(os.path.dirname(__file__), "..", "benchmark",
                        "clips", "broadcast", "bc_gop1.264")
    with open(path, "rb") as f:
        data = f.read()
    before = tlc.lane_encode_streams_idx.launches
    blob = device_compress(data, scope="gop", substream_bins=16384,
                           device=cuda)
    assert tlc.lane_encode_streams_idx.launches > before
    assert blob == codec.compress(data, scope="gop", substream_bins=16384)
    assert native.decompress(blob) == data


def test_est_main_path_launches_kernel(cuda):
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    for scope in ("slice", "gop"):
        before = tec.est_encode.launches
        unpacks = tec.est_unpack.launches
        stats = {}
        out = device_compress(data, scope=scope, substream_bins=0, device=cuda,
                              stats=stats)
        assert tec.est_encode.launches > before
        assert out == native.compress(data, scope=scope)
        # each group's rows unpacked on the card from its records, once
        assert tec.est_unpack.launches - unpacks == stats["est_launches"] > 0
        # every trace coded by the stage-warp kernel
        assert stats["est_stage_traces"] == stats["est_traces"] > 0


def _records(lens, seed, dev):
    """Random 8-byte records (every bit random, p1 and the bits above the
    bin included) of the given lengths on `dev`."""
    rng = np.random.default_rng(seed)
    i64 = np.iinfo(np.int64)
    return [torch.from_numpy(rng.integers(i64.min, i64.max, n, dtype=np.int64,
                                          endpoint=True)).to(dev)
            for n in lens]


# (lens, S): a tiny ragged group with an empty trace, a one-bin one and
# padding rows; an archive-like group, GOP-long traces of millions of bins
# padded to the longest
@pytest.mark.parametrize("lens, S", [
    ((0, 1, 33, 257, 1000), 7),
    ((7_413_348, 7_353_588, 3_000_001, 1, 0), 5),
])
def test_est_unpack_kernel_matches_plain(cuda, lens, S):
    recs = _records(lens, len(lens) + S, cuda)
    T = max(lens)
    before = tec.est_unpack.launches
    got = tec.est_unpack(recs, S, T)
    torch.cuda.synchronize()
    assert tec.est_unpack.launches == before + 1
    for a, b in zip(got, tec.est_unpack_plain(recs, S, T)):
        assert a.device.type == "cuda" and a.dtype == torch.int32
        assert a.shape == (S, T) and torch.equal(a, b)


def test_est_record_groups_behind_running_kernels(cuda, monkeypatch):
    """Small groups, each one's records uploaded through the staging ring
    and unpacked once the est kernel of the group before has finished
    (est_wait): the container equals the host codec's."""
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "mbaff_b.mkv"), "rb").read()
    monkeypatch.setattr(tec, "card_group_bins", lambda dev: 1 << 15)
    unpacks = tec.est_unpack.launches
    stats = {}
    out = device_compress(data, scope="slice", substream_bins=0, device=cuda,
                          stats=stats)
    assert tec.est_unpack.launches - unpacks == stats["est_launches"] > 2
    assert stats["est_wait_s"] > 0  # each group after the first waited
    assert out == native.compress(data, scope="slice")


@pytest.mark.parametrize("free", ["card", "small"])
def test_est_recording_groups_by_free_memory(cuda, monkeypatch, free):
    """A recording of four GOP-long traces at gop scope: with the card's
    free memory one group, one est_unpack and one est_encode launch and no
    wait.  On a card faked small, whose free memory is what the call
    allocates taken off a fixed size, each group reads what the groups
    launched before still hold: the two shortest GOPs go first, then the
    next two each alone, where a budget read once would have put them
    together; each group after the first waits for the kernel before, and
    the call never holds more than the small card.  Either way the host
    codec's container."""
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "mbaff_b.mkv"), "rb").read()
    traces = extract_traces(data, scope="gop")[3]
    assert len(traces) == 4
    if free == "small":
        # the budget read first holds two of the longest GOP and 10,000
        # bins more; the first group's tok and car, 16 B a padded bin of
        # its two GOPs of ~57 K bins, take ~20 K bins of budget off
        lengths = sorted(map(len, traces))
        assert 2 * lengths[1] <= 2 * lengths[3] + 10_000 < 3 * lengths[2]
        size = 2 * tec.EST_BIN_BYTES * (2 * lengths[3] + 10_000)
        device_compress(data, scope="gop", substream_bins=0, device=cuda)
        allocated = torch.cuda.memory_allocated
        base = allocated(cuda)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (
            size - (allocated(dev) - base), 80 << 30))
        monkeypatch.setattr(torch.cuda, "memory_reserved", allocated)
        torch.cuda.reset_peak_memory_stats(cuda)
    encodes, unpacks = tec.est_encode.launches, tec.est_unpack.launches
    stats = {}
    out = device_compress(data, scope="gop", substream_bins=0, device=cuda,
                          stats=stats)
    assert out == native.compress(data, scope="gop")
    launches = stats["est_launches"]
    assert tec.est_encode.launches - encodes == launches
    assert tec.est_unpack.launches - unpacks == launches
    assert stats["est_traces"] == 4
    assert stats["est_memory_cuts"] == launches - 1
    if free == "card":
        assert launches == 1 and stats["est_wait_s"] == 0
    else:
        assert launches == 3 and stats["est_wait_s"] > 0
        assert torch.cuda.max_memory_allocated(cuda) - base <= size


# encoder output of every kind and arbitrary bytes ("bytes": streams of 0-3
# bytes first, p1 = 0 and 0xFFFF among the bins); lane counts off a block's
# 32 lanes (1, 31, 33, 8,191), widths off the kernel's 128-bin tile, lanes
# that end on a tile edge, p1 at its ends, streams with long runs of 0xFF
@pytest.mark.parametrize("kind, L, B", [
    ("random", 1, 32), ("random", 5, 256), ("random", 33, 96),
    ("random", 70, 160), ("carry", 97, 1184), ("random", 300, 1024),
    ("zero", 40, 512), ("bytes", 16, 128), ("bytes", 50, 1184),
    ("bytes", 7, 4128), ("random", 8191, 256), ("edges", 1, 4096),
    ("edges", 31, 4096), ("edges", 33, 1024), ("ffrun", 33, 2048),
    ("bytes", 33, 4096),
])
def test_decode_kernel_matches_plain(cuda, kind, L, B):
    prob, want = _decode_problem(kind, L, B, L + B, cuda)
    before = tld.lane_decode.launches
    got = tld.lane_decode(*prob)
    torch.cuda.synchronize()
    assert tld.lane_decode.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, tld.lane_decode_plain(*prob))
    if want is not None:
        np.testing.assert_array_equal(tld.unpack_bits(got), want)


def test_decode_kernel_long_lane_and_unaligned_starts(cuda):
    """One lane of more than 65,536 bins, and lanes whose streams start at
    every byte alignment of the concatenated buffer."""
    rng = np.random.default_rng(4)
    n = 66000
    streams = [rng.integers(0, 256, k, dtype=np.uint8).tobytes()
               for k in (n // 3, 1, 2, 3, 5, 6, 7, 9)]
    p1 = rng.integers(1, 1 << 16, (len(streams), n))
    lens = np.array([n] + [400] * (len(streams) - 1), np.int32)
    prob = tld.from_numpy_problem(
        *tld.pack_decode_problem(streams, p1, lens), cuda)
    got = tld.lane_decode(*prob)
    # the plain loop over 66,000 bins is slow: hold lane 0 to the host
    # decoder instead, and the short lanes to the plain version
    from avrecode_tpu_torch.ops.rangecoder import RangeDecoder

    dec = RangeDecoder(streams[0])
    want = [dec.get(int(p)) for p in p1[0]]
    bits = tld.unpack_bits(got)
    assert bits[0, :n].tolist() == want and not bits[:, n:].any()
    short = tuple(t.clone() for t in prob)
    short[3][0] = 400
    ref = tld.unpack_bits(tld.lane_decode_plain(*short))
    np.testing.assert_array_equal(bits[1:], ref[1:])
    assert not bits[1:, 400:].any()


def test_decode_kernel_lone_unit(cuda):
    """One lane as long as the longest pinned v1 unit, from the host
    encoder: the bits that went in come out."""
    prob, want = one_long_lane(LONE_UNIT, 12, cuda)
    np.testing.assert_array_equal(tld.unpack_bits(tld.lane_decode(*prob)),
                                  want)


def test_decode_kernel_rejects_misaligned_p1(cuda):
    prob, _ = _decode_problem("bytes", 4, 64, 1, cuda)
    flat = torch.zeros(4 * 64 + 1, dtype=torch.uint16, device=cuda)
    view = flat[1:].view(4, 64)  # contiguous, two bytes off the boundary
    with pytest.raises(ValueError, match="16-byte"):
        tld.lane_decode(prob[0], prob[1], view, prob[3])


@pytest.mark.parametrize("scope, B", [("gop", 4096), ("slice", 512),
                                      ("gop", 0)])
def test_device_decompress_launches_kernel(cuda, scope, B):
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    blob = (codec.compress(data, scope=scope, substream_bins=B) if B
            else native.compress(data, scope=scope))
    before = tld.lane_decode.launches
    assert device_decompress(blob, device=cuda) == data
    assert tld.lane_decode.launches == before + 1


def _cuda_step_rank(rank, world, device, arrays):
    """multichip_step on one rank that shares the card."""
    before = tec.est_encode.launches
    out, lens, total = multichip_step(*arrays, device=device)
    return out, lens, total, tec.est_encode.launches - before


@pytest.mark.parametrize("n", [1, 4, 7])
def test_mesh_of_streams_on_one_card(cuda, n):
    """n shards on streams of card 0: the bytes of the call without a mesh,
    one lane_encode_streams_idx launch a non-empty shard of traces (native
    traces take the index form); the est path and the sharded decode
    alike."""
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "mbaff_b.mkv"), "rb").read()
    mesh = make_mesh(n, device="cuda:0")
    assert mesh == (torch.device("cuda", 0),) * n
    traces = extract_traces(data, scope="gop", want_slots=False)[3]
    assert len(traces) == 4  # 4 GOPs, cut over the shards
    before = tlc.lane_encode_streams_idx.launches
    out = device_compress(data, mesh=mesh, scope="gop", substream_bins=4096)
    assert tlc.lane_encode_streams_idx.launches - before == min(n, 4)
    assert out == codec.compress(data, scope="gop", substream_bins=4096)
    before = tec.est_encode.launches
    est = device_compress(data, mesh=mesh, scope="gop", substream_bins=0)
    assert tec.est_encode.launches - before == min(n, 4)  # 4 GOPs
    assert est == native.compress(data, scope="gop")

    prob, want = _decode_problem("random", 70, 160, 230, cuda)
    streams = [bytes(prob[0][int(a):int(b)].cpu().numpy())
               for a, b in zip(prob[1][:-1], prob[1][1:])]
    p1s, lens = prob[2].cpu().numpy(), prob[3].cpu().numpy()
    before = tld.lane_decode.launches
    bits = tld.decode_streams_lanes(streams, p1s, lens, mesh=mesh)
    assert tld.lane_decode.launches - before == n
    assert bits.device == torch.device("cuda", 0)
    np.testing.assert_array_equal(bits.cpu().numpy(), want)


def test_mesh_est_groups_take_turns(cuda, monkeypatch):
    """The est path over two shards on card 0, a group a trace: each shard
    waits only for its own kernel before its next group, so the shards'
    groups go up and launch in turns; the bytes of the call without a
    mesh."""
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "mbaff_b.mkv"), "rb").read()
    traces = extract_traces(data, scope="gop")[3]
    monkeypatch.setattr(tec, "card_group_bins", lambda dev: 1)
    want = tec.encode_traces_est(traces, cuda)
    mesh = make_mesh(2, device="cuda:0")
    real, log = tec._records_problem, []

    def records_problem(*args):
        log.append(torch.cuda.current_stream(cuda))
        return real(*args)

    monkeypatch.setattr(tec, "_records_problem", records_problem)
    assert tec.encode_traces_est(traces, mesh=mesh) == want
    # 4 GOPs, 2 a shard, each shard on a stream of its own
    assert log[0] != log[1] and log == log[:2] * 2


def test_two_ranks_share_the_card(cuda):
    """multichip_step and the dry run over ranks that share card 0: gloo
    carries the collectives, every rank launches the CUDA kernels."""
    from avrecode_tpu_torch import graft_entry
    from avrecode_tpu_torch.ops.estimator import stream_bytes
    from avrecode_tpu_torch.parallel import ranks

    arrays = _est_problem("random", 8, 200, 32, seed=3)
    arrays = tuple(np.asarray(a, np.int32) for a in arrays)
    want = tec.est_collect(*tec.est_encode(
        *tec.from_numpy_traces(*arrays, cuda)))
    reports = ranks.run_ranks(_cuda_step_rank, 2, (arrays,),
                                  device="cuda:0")
    assert [r["backend"] for r in reports] == ["gloo", "gloo"]
    got = []
    for out, lens, total, launches in (r["result"] for r in reports):
        assert launches == 1 and total == sum(map(len, want))
        got += [stream_bytes(out[i], lens[i]) for i in range(len(lens))]
    assert got == want
    reports = graft_entry.dryrun_multichip(2)
    assert all(r["result"]["launches"] >= 1 for r in reports)
    assert all(r["result"]["device"].startswith("cuda") for r in reports)
