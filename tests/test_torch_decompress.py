"""Port decode direction vs the host codec and the JAX pipeline on the
pinned real clips: avrecode_tpu_torch.parallel.pipeline.device_decompress
(plain torch decoder, device="cpu") must return the original file, the
port's codec.decompress(blob) and avrecode_tpu's device_decompress(blob)
byte for byte, for v2 containers at gop and slice scope and for a v1
container; the bins of its device phase must equal the bins the host model
pass decoded.  Also the port's entry() step against the JAX entry()."""

import functools
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from avrecode_tpu import codec as jcodec
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import codec, graft_entry
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.ops import lane_decoder as tld
from avrecode_tpu_torch.parallel import pipeline as tpipe

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@functools.cache
def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@functools.cache
def _container(clip, scope, B):
    """A v2 container from the port's host codec; a v1 one (B = 0) from its
    C++ codec."""
    if B:
        return codec.compress(_read(clip), scope=scope, substream_bins=B)
    return native.compress(_read(clip), scope=scope)


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


# a v1 unit is one lane of all its bins: slice scope keeps it under 16K
@pytest.mark.parametrize("clip, scope, B", [
    ("rt_ctr.mkv", "gop", 512), ("mbaff_b.mkv", "gop", 4096),
    ("rt_ctr.mkv", "slice", 512), ("rt_ctr.mkv", "slice", 0),
    ("cavlc_rt.mp4", "gop", 512),
])
def test_device_decompress_matches_host(clip, scope, B):
    if not os.path.exists(os.path.join(DATA, clip)):
        pytest.skip(f"data/{clip} is not present")
    blob = _container(clip, scope, B)
    out = tpipe.device_decompress(blob, device="cpu")
    assert out == _read(clip)
    assert out == codec.decompress(blob)


def test_device_decompress_matches_jax_pipeline():
    """Both packages decode a container of the JAX package's host codec."""
    data = _read("rt_ctr.mkv")
    blob = jcodec.compress(data, scope="gop", substream_bins=4096)
    assert blob == _container("rt_ctr.mkv", "gop", 4096)
    assert (tpipe.device_decompress(blob, device="cpu")
            == jpipe.device_decompress(blob) == data)


@pytest.mark.parametrize("scope, B", [("gop", 512), ("slice", 0)])
def test_phase_b_bins_equal_recorded_bins(scope, B):
    blob = _container("rt_ctr.mkv", scope, B)
    host_out, units = tpipe.record_units(blob)
    assert host_out == _read("rt_ctr.mkv") and len(units) > 1
    stream, offs, p1u16, lens, spans = tpipe.pack_units(units)
    counts = [len(m.rec_p1s) for m in units]
    width = B or max(counts)
    assert p1u16.shape == (spans[-1][1], -(-width // tlc.CHUNK) * tlc.CHUNK)
    assert [int(lens[lo:hi].sum()) for lo, hi in spans] == counts
    assert all(hi - lo == -(-n // width) for (lo, hi), n in zip(spans, counts))
    assert offs[-1] == sum(
        len(s) for m in units for s in (m.streams if B else [m.raw]))
    before = tld.lane_decode.launches
    unit_bits = tpipe.decode_units(units, device="cpu")
    assert tld.lane_decode.launches == before  # the CPU runs the plain version
    assert unit_bits == [m.rec_bits for m in units]
    assert tpipe.assemble_units(blob, unit_bits) == host_out


def test_pack_units_edge_cases():
    """No unit, a unit without bins, a unit with too few sub-streams (a
    corrupted envelope reads as empty streams), and a p1 out of range."""

    class Unit:
        def __init__(self, B, streams, p1s):
            self.B, self.streams, self.raw = B, streams, b"".join(streams)
            self.rec_p1s = p1s

    stream, offs, p1u16, lens, spans = tpipe.pack_units([])
    assert p1u16.shape[0] == 0 and spans == [] and offs.tolist() == [0]
    assert tpipe.decode_units([], device="cpu") == []
    units = [Unit(4, [b"ab", b"c"], [7] * 6), Unit(4, [], []),
             Unit(4, [b"xyz"], [9] * 9)]
    stream, offs, p1u16, lens, spans = tpipe.pack_units(units)
    assert spans == [(0, 2), (2, 2), (2, 5)]
    assert lens.tolist() == [4, 2, 4, 4, 1]
    assert offs.tolist() == [0, 2, 3, 6, 6, 6]  # two lanes without a stream
    assert bytes(stream[:6]) == b"abcxyz" and stream.size % 16 == 0
    assert p1u16[:, :4].tolist() == [[7] * 4, [7, 7, 0, 0], [9] * 4, [9] * 4,
                                     [9, 0, 0, 0]]
    bits = tpipe.decode_units(units, device="cpu")
    assert [len(b) for b in bits] == [6, 0, 9]
    with pytest.raises(ValueError, match="0xFFFF"):
        tpipe.pack_units([Unit(0, [b"ab"], [1, 0x10000])])


def test_flipped_stream_byte_never_returns_wrong_bytes():
    """Damage inside the entropy streams: the device path raises wherever
    the host decoder raises, and otherwise returns exactly what the host
    decoder returns."""
    data = _read("rt_ctr.mkv")
    blob = _container("rt_ctr.mkv", "gop", 512)
    raised = 0
    for at in (len(blob) // 2, len(blob) - 2000, len(blob) - 40):
        bad = bytearray(blob)
        bad[at] ^= 0x55
        try:
            want = codec.decompress(bytes(bad))
        except Exception as e:  # the host decoder rejects the damage
            raised += 1
            with pytest.raises(type(e)):
                tpipe.device_decompress(bytes(bad), device="cpu")
            continue
        assert tpipe.device_decompress(bytes(bad), device="cpu") == want != data
    assert raised


def test_feed_of_wrong_bins_is_not_silent():
    """Bins that differ from the host pass cannot give the host's bytes."""
    blob = _container("rt_ctr.mkv", "gop", 512)
    host_out, units = tpipe.record_units(blob)
    wrong = [list(m.rec_bits) for m in units]
    for k in range(40, 400, 7):
        wrong[0][k] ^= 1
    try:
        out = tpipe.assemble_units(blob, wrong)
    except Exception:
        return
    assert out != host_out


def test_device_decompress_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = _container("rt_ctr.mkv", "gop", 512)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.device_decompress(blob, device=dev)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.decode_units([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_entry_step_matches_jax_entry():
    step, args = graft_entry.entry(device="cpu")
    jstep, (bitp1, lens) = jentry.entry()
    p1u16, bitw, lens_t = args
    assert all(a.device.type == "cpu" for a in args)
    np.testing.assert_array_equal(tlc.to_bitp1(p1u16.numpy(), bitw.numpy()),
                                  bitp1)
    np.testing.assert_array_equal(lens_t.numpy(), lens)
    out, nbytes, overflow = step(*args)
    jout, jnb, jov = jstep(bitp1, lens)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(nbytes.numpy(), np.asarray(jnb))
    assert bool(overflow) == bool(jov) is False
    # and the step's bytes are the host finalize of the same tokens
    raw = [t.numpy() for t in tlc.lane_encode(*args)]
    assert [bytes(out[l, : nbytes[l]].numpy()) for l in range(8)] \
        == tlc.finalize_lanes(*raw, lens)
