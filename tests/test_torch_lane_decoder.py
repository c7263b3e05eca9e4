"""Port lane decoder vs the JAX reference: the plain torch decoder, the
kernel wrapper's CPU route and the packers must equal
avrecode_tpu.ops.lane_decoder (XLA scan) exactly, on encoder output and on
arbitrary bytes, and must invert the port's own lane encoder.  The
arithmetic is exact integers, so every comparison has tolerance zero.
Inputs are made from numpy seeds and handed to both implementations as
numpy arrays."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avrecode_tpu.ops import lane_decoder as jld
from avrecode_tpu.ops.rangecoder import PROB_ONE, RangeEncoder
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.ops import lane_decoder as tld
from avrecode_tpu_torch.ops.rangecoder import RangeDecoder

CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _lanes(kind, B, seed, L=7):
    """Synthetic packed int32 (p1 | bit << 16) [L, B] lanes and ragged lens
    (0, 1, B-1, B and random).  "carry": p1 near 0xFFFF with 30% of bins
    coded against it (pending carries and 0xFF byte runs)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        p1 = rng.integers(1, 1 << 16, (L, B))
        bits = rng.random((L, B)) < p1 / 65536
    else:
        p1 = rng.integers(0xFFF0, 1 << 16, (L, B))
        bits = rng.random((L, B)) > 0.3
    bitp1 = (p1 | (bits.astype(np.int64) << 16)).astype(np.int32)
    lens = np.array([0, 1, B - 1, B] + list(rng.integers(0, B + 1, L - 4)),
                    np.int32)
    return bitp1, lens


def _encode(bitp1, lens):
    """The port's own lane encoder and host finalize -> stream bytes."""
    p1u16, bitw, lens_p = tlc.pack_compact(bitp1, lens, pad_lanes=1)
    raw = tlc.lane_encode(*tlc.from_numpy_problem(p1u16, bitw, lens_p, CPU))
    return tlc.finalize_lanes(*(t.numpy() for t in raw), lens)


def _both(streams, p1s, lens):
    """(JAX bits, port bits) of one decode problem, as numpy [L, B]."""
    p1s = np.asarray(p1s, np.int32)
    lens = np.asarray(lens, np.int32)
    ref = np.asarray(jld.decode_streams_lanes(list(streams), p1s, lens))
    got = tld.decode_streams_lanes(list(streams), p1s, lens, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    return ref, got.numpy()


@pytest.mark.parametrize("B", [64, 257, 1024])
@pytest.mark.parametrize("kind", ["random", "carry"])
def test_decode_inverts_port_encoder_and_matches_jax(kind, B):
    bitp1, lens = _lanes(kind, B, seed=B)
    streams = _encode(bitp1, lens)
    assert streams[0] == b""  # an empty lane: even the start reads past it
    ref, got = _both(streams, bitp1 & 0xFFFF, lens)
    np.testing.assert_array_equal(got, ref)
    mask = np.arange(B)[None, :] < lens[:, None]
    np.testing.assert_array_equal(got, ((bitp1 >> 16) & 1) * mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_bytes_short_streams_and_p1_zero(seed):
    """The decoder is defined on any bytes: streams of 0-5 bytes, streams
    longer than their lane reads, and p1 = 0 (which no model gives)."""
    rng = np.random.default_rng(seed)
    B = 300
    sizes = [0, 1, 2, 3, 4, 5, 100, 700, 50]
    streams = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in sizes]
    p1 = rng.integers(0, 1 << 16, (len(sizes), B))
    p1[rng.random(p1.shape) < 0.02] = 0
    p1[rng.random(p1.shape) < 0.02] = 0xFFFF
    lens = np.array([0, 1, B - 1, B, 7, B, B, B, 33], np.int32)
    ref, got = _both(streams, p1, lens)
    np.testing.assert_array_equal(got, ref)
    assert ref.any() and not got[0].any() and not got[4, 7:].any()


def test_decode_matches_host_encoder_and_decoder():
    rng = np.random.RandomState(3)
    B = 128
    p1 = rng.randint(1, PROB_ONE, B)
    bit = rng.randint(0, 2, B)
    enc = RangeEncoder()
    for b, p in zip(bit, p1):
        enc.put(int(b), int(p))
    stream = bytes(enc.finish())
    ref, got = _both([stream], p1[None, :], [B])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], bit)
    dec = RangeDecoder(stream)
    assert [dec.get(int(p)) for p in p1] == list(bit)


def test_decode_real_traces():
    if not native.available():
        pytest.skip("native library not built")
    with open(os.path.join(DATA, "rt_ctr.mkv"), "rb") as f:
        traces = native.extract(f.read(), "gop", want_slots=False)[3]
    bitp1, lens, _ = tlc.split_lanes(traces, 1024)
    bitp1, lens = bitp1[:24], lens[:24]
    ref, got = _both(_encode(bitp1, lens), bitp1 & 0xFFFF, lens)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, (bitp1 >> 16) & 1)


def test_decode_step_matches_jax_step():
    """A few hundred single steps from one state, both packages: state and
    bits, with the JAX int32 state read as uint32."""
    rng = np.random.default_rng(5)
    L, T = 6, 300
    streams = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
               for n in (0, 3, 40, 200, 700, 700)]
    p1 = rng.integers(0, 1 << 16, (L, T))
    valid = rng.random((L, T)) < 0.9
    M = 4 + 2 * T + 4
    rows = np.zeros((L, M), np.int32)
    for i, s in enumerate(streams):
        rows[i, : min(len(s), M)] = np.frombuffer(s, np.uint8)[:M]
    jst = (jnp.asarray(rows[:, 0] << 24 | rows[:, 1] << 16 | rows[:, 2] << 8
                       | rows[:, 3], jnp.int32),
           jnp.full((L,), -1, jnp.int32), jnp.full((L,), 4, jnp.int32))
    stream, offs, _, _ = tld.problem_from_padded(rows, p1, np.full(L, T))
    byte_at = tld.byte_feed(torch.from_numpy(stream), torch.from_numpy(offs))
    tst = tuple(torch.from_numpy(np.asarray(a).astype(np.int64) & 0xFFFFFFFF)
                for a in jst)
    for i in range(T):
        *jst, jbit = jld.decode_step(
            *jst, jnp.asarray(rows), jnp.asarray(p1[:, i], jnp.int32),
            jnp.asarray(valid[:, i]))
        *tst, tbit = tld.decode_step(
            *tst, byte_at, torch.from_numpy(p1[:, i]),
            torch.from_numpy(valid[:, i]))
        for a, b in zip(jst, tst):
            np.testing.assert_array_equal(
                np.asarray(a).astype(np.int64) & 0xFFFFFFFF, b.numpy())
        np.testing.assert_array_equal(np.asarray(jbit), tbit.numpy())


def test_layout_converter_feeds_both_from_one_problem():
    """The JAX-side padded problem -> the port's tensors -> same bits."""
    rng = np.random.default_rng(9)
    L, B, M = 5, 200, 4 + 2 * 200 + 4
    rows = np.zeros((L, M), np.int32)
    for i, n in enumerate((0, 2, 60, 150, M)):
        rows[i, :n] = rng.integers(0, 256, n)
    p1 = rng.integers(1, 1 << 16, (L, B)).astype(np.int32)
    lens = np.array([B, B, 0, 77, B], np.int32)
    ref = np.asarray(jld.lane_decode_scan(rows, p1, lens))
    prob = tld.problem_from_padded(rows, p1, lens)
    stream, offs, p1u16, lens_p = prob
    assert stream.dtype == np.uint8 and stream.size % 16 == 0
    assert offs.tolist() == [i * M for i in range(L + 1)]
    assert p1u16.dtype == np.uint16 and p1u16.shape == (L, 256)
    assert not p1u16[:, B:].any()
    bitw = tld.lane_decode(*tld.from_numpy_problem(*prob, CPU))
    assert bitw.dtype == torch.int32 and tuple(bitw.shape) == (L, 8)
    np.testing.assert_array_equal(tld.unpack_bits(bitw, B), ref)
    assert not tld.unpack_bits(bitw)[:, B:].any()
    with pytest.raises(ValueError, match="byte values"):
        tld.problem_from_padded(rows + 256, p1, lens)


def test_pack_bits_roundtrip_and_offset_clamping():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (4, 96)).astype(np.uint8)
    bits[0, 31] = 1  # a word with its sign bit set
    words = tld.pack_bits(torch.from_numpy(bits))
    assert words.dtype == torch.int32 and int(words[0, 0]) < 0
    np.testing.assert_array_equal(tld.unpack_bits(words), bits)
    ref = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    np.testing.assert_array_equal(words.numpy(), ref)
    # offsets outside the buffer or out of order read as empty or cut lanes
    stream = torch.from_numpy(rng.integers(0, 256, 32, dtype=np.uint8))
    p1 = torch.from_numpy(rng.integers(1, 1 << 16, (3, 64)).astype(np.uint16))
    lens = torch.full((3,), 64, dtype=torch.int32)
    wild = tld.lane_decode(stream, torch.tensor([-5, 20, 10, 99]), p1, lens)
    # = lanes [0, 20), [20, 20) and [10, 32) of the buffer
    laid = torch.cat([stream[:20], stream[10:], stream[:6]])
    tame = tld.lane_decode(laid, torch.tensor([0, 20, 20, 42]), p1, lens)
    assert torch.equal(wild, tame)


def test_wrapper_on_cpu_runs_plain_without_launch():
    bitp1, lens = _lanes("random", 300, seed=3)
    prob = tld.from_numpy_problem(
        *tld.pack_decode_problem(_encode(bitp1, lens), bitp1 & 0xFFFF, lens),
        CPU)
    before = tld.lane_decode.launches
    got = tld.lane_decode(*prob)
    assert tld.lane_decode.launches == before
    assert torch.equal(got, tld.lane_decode_plain(*prob))
    empty = tld.decode_streams_lanes([], np.zeros((0, 8), np.int32), [],
                                     device="cpu")
    assert tuple(empty.shape) == (0, 0)


def _good_problem(L=3, B=64):
    return (torch.zeros(16, dtype=torch.uint8),
            torch.zeros(L + 1, dtype=torch.int64),
            torch.zeros((L, B), dtype=torch.uint16),
            torch.zeros(L, dtype=torch.int32))


@pytest.mark.parametrize("bad, err", [
    (lambda s, o, p, l: (s.to(torch.int32), o, p, l), TypeError),
    (lambda s, o, p, l: (s, o.to(torch.int32), p, l), TypeError),
    (lambda s, o, p, l: (s, o, p.to(torch.int32), l), TypeError),
    (lambda s, o, p, l: (s, o, p, l.to(torch.int64)), TypeError),
    (lambda s, o, p, l: (s[:15], o, p, l), ValueError),
    (lambda s, o, p, l: (s.reshape(4, 4), o, p, l), ValueError),
    (lambda s, o, p, l: (s, o[:3], p, l), ValueError),
    (lambda s, o, p, l: (s, o, p[:, :48].contiguous(), l), ValueError),
    (lambda s, o, p, l: (s, o, p.reshape(-1), l), ValueError),
    (lambda s, o, p, l: (s, o, p, l[:2]), ValueError),
    (lambda s, o, p, l: (s, o, torch.zeros((3, 128), dtype=torch.uint16)[:, ::2],
                         l), ValueError),
    (lambda s, o, p, l: (s.to("meta"), o.to("meta"), p.to("meta"),
                         l.to("meta")), ValueError),
    (lambda s, o, p, l: (s.to("meta"), o, p, l), ValueError),
], ids=["stream-dtype", "offs-dtype", "p1-dtype", "lens-dtype", "N-not-16",
        "stream-2d", "offs-shape", "B-not-32", "p1-1d", "lens-shape",
        "noncontig", "meta-device", "mixed-devices"])
def test_wrapper_rejects_bad_problems(bad, err):
    with pytest.raises(err):
        tld.lane_decode(*bad(*_good_problem()))


@pytest.mark.parametrize("p1s, err", [
    ([[0, 0x10000]], ValueError), ([[-1, 5]], ValueError),
    ([[0.5, 0.25]], TypeError),
], ids=["too-big", "negative", "float"])
def test_packer_rejects_bad_p1(p1s, err):
    with pytest.raises(err):
        tld.pack_decode_problem([b"ab"], np.asarray(p1s), [2])
    with pytest.raises(ValueError, match="one row per stream"):
        tld.pack_decode_problem([b"ab", b""], np.zeros((1, 4), np.int32), [2])


def test_decode_streams_lanes_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tld.decode_streams_lanes([b""], np.ones((1, 4), np.int32), [4])
