"""Port pipeline vs the JAX pipeline and the host codec on the pinned real
clips: containers from avrecode_tpu_torch.parallel.pipeline (plain torch
path, device="cpu") must be byte-identical to
avrecode_tpu.parallel.pipeline.device_compress and to
codec.compress(scope, substream_bins=B), for native and Python-extracted
traces, per file and through the cross-file corpus batcher."""

import os

import numpy as np
import pytest

from avrecode_tpu import codec
from avrecode_tpu.host import native
from avrecode_tpu.ops import lane_coder as jlc
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch.models.h264_model import _make_envelope
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline as tpipe

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv"]
B = 1024


def _read(name):
    return open(os.path.join(DATA, name), "rb").read()


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


@pytest.mark.parametrize("scope", ["slice", "gop"])
@pytest.mark.parametrize("clip", CLIPS)
def test_device_compress_matches_jax_and_host(clip, scope):
    data = _read(clip)
    port = tpipe.device_compress(data, scope=scope, substream_bins=B,
                                 device="cpu")
    assert port == jpipe.device_compress(data, scope=scope, substream_bins=B)
    assert port == codec.compress(data, scope=scope, substream_bins=B)
    assert native.decompress(port) == data


@pytest.mark.parametrize("clip", CLIPS)
def test_python_extractor_path(clip):
    """Python-extracted traces go through split_lanes + pack_compact and
    give the envelopes of the native traces and of the JAX scan path."""
    data = _read(clip)
    *_, py_traces, stats = tpipe.extract_traces(data, use_native=False,
                                                scope="gop")
    *_, nat_traces, nstats = tpipe.extract_traces(data, scope="gop",
                                                  want_slots=False)
    assert stats["native"] is False and nstats["native"] is True
    assert not any(hasattr(t, "recs32") for t in py_traces)
    envs = tlc.encode_traces_lanes(py_traces, B, device="cpu")
    assert envs == jlc.encode_traces_lanes(py_traces, B, use_pallas=False)
    assert envs == tlc.encode_traces_lanes(nat_traces, B, device="cpu")


def test_corpus_matches_per_file():
    datas = [_read(c) for c in CLIPS] + [b"not a video at all"]
    stats = {}
    outs = tpipe.device_compress_corpus(datas, scope="gop", substream_bins=B,
                                        device="cpu", stats=stats)
    per_file = [tpipe.device_compress(d, scope="gop", substream_bins=B,
                                      device="cpu") for d in datas]
    assert outs == per_file
    assert outs[-1] == codec.compress(datas[-1], scope="gop", substream_bins=B)
    assert stats["dispatches"] == 1 and stats["bins"] > 0


def test_lane_batcher_matches_per_file():
    """Tiny groups (two rows) force splits across segment boundaries; the
    global stream list must equal the per-file dispatch row for row."""
    _, _, _, traces = native.extract(_read(CLIPS[0]), "gop", want_slots=False)
    p1u16, bitw, lens, _ = tlc.split_lanes_recs(traces, 512)
    jp1, jbw, jl, _ = jlc.split_lanes_recs(traces, 512)
    for a, b in zip((p1u16, bitw, lens), (jp1, jbw, jl)):
        np.testing.assert_array_equal(a, b)
    # the first 16 rows keep the plain CPU encoder quick: 8 two-row groups
    p1u16, bitw, lens = p1u16[:16], bitw[:16], lens[:16]
    per_file = tlc.lane_streams_device_compact(p1u16, bitw, lens, "cpu")

    bat = tlc.LaneBatcher("cpu", 2)
    ranges = [bat.add(p1u16[lo:lo + 3], bitw[lo:lo + 3], lens[lo:lo + 3])
              for lo in range(0, p1u16.shape[0], 3)]
    got = bat.finish()
    assert [h[0] for h in bat.pending] == [2] * 8
    assert [got.envelope(l, l + 1) for l in range(16)] == [
        _make_envelope([s]) for s in per_file]
    assert got.envelope(0, 16) == _make_envelope(per_file)
    assert ranges[0][0] == 0 and ranges[-1][1] == p1u16.shape[0]


def test_auto_and_unported_options():
    data = _read(CLIPS[0])
    auto = tpipe.device_compress(data, scope="gop", substream_bins="auto",
                                 device="cpu")
    assert auto == codec.compress(data, scope="gop", substream_bins=2048)
    # the corpus path is lane-only, as in the JAX package
    with pytest.raises(ValueError, match="substream_bins"):
        tpipe.device_compress_corpus([data], scope="gop", substream_bins=0,
                                     device="cpu")


def test_no_traces_input_is_host_compressed():
    data = b"\x00\x00\x01 not h264" * 40
    out = tpipe.device_compress(data, scope="gop", device="cpu")
    assert out == codec.compress(data, scope="gop", substream_bins=4096)
    assert codec.decompress(out) == data


def test_recs_packing_matches_python_packing():
    """split_lanes_recs (native records) and split_lanes + pack_compact
    (trace arrays) build the same compact problem."""
    _, _, _, traces = native.extract(_read(CLIPS[1]), "gop", want_slots=False)
    for b in (256, 1000):
        p1u16, bitw, lens, spans = tlc.split_lanes_recs(traces, b)
        bitp1, lens2, spans2 = tlc.split_lanes(traces, b)
        q1, qw, ql = tlc.pack_compact(bitp1, lens2, pad_lanes=1)
        assert spans == spans2
        for x, y in zip((p1u16, bitw, lens), (q1, qw, ql)):
            np.testing.assert_array_equal(x, y)
