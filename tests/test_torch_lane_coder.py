"""Port lane coder vs the JAX reference: the plain torch encoder, the
kernel wrapper's CPU route, the torch finalize and the trace front end must
equal avrecode_tpu.ops.lane_coder (XLA scan, Pallas in interpret mode,
numpy and XLA finalize) and the host RecodeModel exactly.  The arithmetic
is exact integers, so every comparison has tolerance zero.  Inputs are made
from numpy seeds and handed to both implementations as numpy arrays."""

import inspect
import random

import numpy as np
import pytest
import torch

from avrecode_tpu.models.h264_model import RecodeModel
from avrecode_tpu.models.trace import TraceModel
from avrecode_tpu.ops import lane_coder as jlc
from avrecode_tpu_torch.ops import lane_coder as tlc
from chip_smoke import lanes as _smoke_lanes

CPU = torch.device("cpu")


def _drive(seq, B):
    """Feed one (key, bit, pcab) sequence to both the host model and the
    trace recorder; return (host envelope, trace)."""
    m = RecodeModel("encode", substream_bins=B)
    t = TraceModel()
    for k, bit, pcab in seq:
        m.put_bit(k, bit, pcab)
        t.put_bit(k, bit, pcab)
    return m.finish(), t


def _mk(seed, n):
    rng = random.Random(seed)
    keys = [("ctx", i) for i in range(40)] + [("sig", 2, i, 0, 1) for i in range(14)]
    biases = {k: rng.random() for k in keys}
    return [
        (
            k,
            1 if rng.random() < biases[k] else 0,
            rng.choice([None, None, rng.randint(1, 0xFFFF)]),
        )
        for k in [rng.choice(keys) for _ in range(n)]
    ]


def _lanes(kind, B, seed, L=7):
    """Synthetic packed int32 (p1 | bit << 16) [L, B] lanes and ragged lens
    (0, 1, B-1, B and random).  "carry": p1 near 0xFFFF with 30% of bins
    coded against it, which makes pending carries and 0xFF byte runs."""
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


def _port_tokens(bitp1, lens):
    p1u16, bitw, lens_p = tlc.pack_compact(bitp1, lens, pad_lanes=1)
    return [t.numpy() for t in tlc.lane_encode_plain(
        *tlc.from_numpy_problem(p1u16, bitw, lens_p, CPU))]


@pytest.mark.parametrize("B", [64, 257, 1024])
@pytest.mark.parametrize("kind", ["random", "carry"])
def test_plain_matches_jax_scan_and_pallas(kind, B):
    bitp1, lens = _lanes(kind, B, seed=B)
    tok, car, ftok, fcar = _port_tokens(bitp1, lens)
    assert tok.dtype == car.dtype == ftok.dtype == fcar.dtype == np.int32
    assert tok.shape[1] % tlc.CHUNK == 0
    assert not tok[:, B:].any() and not car[:, B:].any()  # bin padding
    port = (tok[:, :B], car[:, :B], ftok, fcar)
    scan = jlc.lane_encode_scan(bitp1, lens)
    pallas = jlc.lane_encode_pallas(bitp1, lens, interpret=True)
    for a, s, p in zip(port, scan, pallas):
        np.testing.assert_array_equal(a, np.asarray(s))
        np.testing.assert_array_equal(a, np.asarray(p))
    if kind == "carry":  # the case stresses what it claims to
        n = (tok >> 16) & 3
        assert car.max() >= 1 and (((tok & 0xFF) == 0xFF) & (n >= 1)).sum() > 10


def test_wrapper_on_cpu_runs_plain_without_launch():
    bitp1, lens = _lanes("random", 300, seed=3)
    prob = tlc.from_numpy_problem(*tlc.pack_compact(bitp1, lens, pad_lanes=1), CPU)
    before = tlc.lane_encode.launches
    got = tlc.lane_encode(*prob)
    assert tlc.lane_encode.launches == before
    for a, b in zip(got, tlc.lane_encode_plain(*prob)):
        assert torch.equal(a, b)


def test_to_bitp1_roundtrip():
    bitp1, lens = _lanes("random", 257, seed=5)
    p1u16, bitw, _ = tlc.pack_compact(bitp1, lens, pad_lanes=1)
    back = tlc.to_bitp1(p1u16, bitw)
    assert back.dtype == np.int32 and back.shape == (7, 512)
    np.testing.assert_array_equal(back[:, :257], bitp1)
    assert not back[:, 257:].any()


def _good_problem(L=3, B=64):
    return (torch.zeros((L, B), dtype=torch.uint16),
            torch.zeros((L, B // 32), dtype=torch.int32),
            torch.zeros(L, dtype=torch.int32))


@pytest.mark.parametrize("bad, err", [
    (lambda p, w, l: (p.to(torch.int32), w, l), TypeError),
    (lambda p, w, l: (p, w.to(torch.int64), l), TypeError),
    (lambda p, w, l: (p[:, :48].contiguous(), w, l), ValueError),
    (lambda p, w, l: (p, w[:, :1].contiguous(), l), ValueError),
    (lambda p, w, l: (p, w, l[:2]), ValueError),
    (lambda p, w, l: (p.reshape(-1), w, l), ValueError),
    (lambda p, w, l: (torch.zeros((3, 128), dtype=torch.uint16)[:, ::2], w, l),
     ValueError),
    (lambda p, w, l: (torch.zeros((1, 2 * tlc.MAX_B), dtype=torch.uint16),
                      torch.zeros((1, tlc.MAX_B // 16), dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32)), ValueError),
    (lambda p, w, l: (p.to("meta"), w.to("meta"), l.to("meta")), ValueError),
    (lambda p, w, l: (p.to("meta"), w, l), ValueError),
], ids=["p1-dtype", "bitw-dtype", "B-not-32", "bitw-shape", "lens-shape",
        "p1-1d", "noncontig", "B-too-big", "meta-device", "mixed-devices"])
def test_wrapper_rejects_bad_problems(bad, err):
    with pytest.raises(err):
        tlc.lane_encode(*bad(*_good_problem()))


@pytest.mark.parametrize("bits_per_byte", [1, 4, 1000])
@pytest.mark.parametrize("kind", ["random", "carry"])
def test_finalize_device_matches_jax_and_numpy(kind, bits_per_byte):
    B = 512
    bitp1, lens = _lanes(kind, B, seed=11)
    toks = _port_tokens(bitp1, lens)
    M = tlc.max_bytes(B, bits_per_byte)
    out, nbytes, overflow = tlc.finalize_device(
        *(torch.from_numpy(t) for t in toks), M)
    jout, jnb, jov = jlc._finalize_device(*toks, M)
    assert out.dtype == torch.uint8 and out.shape == (len(lens), M)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(nbytes.numpy(), np.asarray(jnb))
    emitted = ((toks[0] >> 16) & 3).sum(axis=1).max()
    assert bool(overflow) == bool(jov) == (emitted + 2 > M)
    if bits_per_byte == 1:
        assert not bool(overflow)
    if not bool(overflow):
        expect = tlc.finalize_lanes(*toks, lens)
        assert expect == jlc.finalize_lanes(*toks, lens)
        got = [bytes(out[l, : nbytes[l]].numpy()) for l in range(len(lens))]
        assert got == expect


@pytest.mark.parametrize("bits_per_byte", [1, 4, 1000])
@pytest.mark.parametrize("kind, B", [
    ("random", 64), ("random", 257), ("random", 1024),
    ("carry", 64), ("carry", 257), ("carry", 1024), ("ffrun", 1024)])
def test_streams_match_jax_pipeline(kind, B, bits_per_byte):
    """lane_encode_streams (its CPU route) against the JAX package's
    _lane_pipeline_jit with the Pallas kernel in interpret mode: exact on
    every lane's out[:nbytes], on nbytes and on the overflow flag.
    "ffrun": one carry through a run of 0xFF as long as the stream, into
    position 0, from a bin or from the flush."""
    if kind == "ffrun":
        p1u16, bitw, lens = _smoke_lanes(kind, 7, B, seed=B)
    else:
        p1u16, bitw, lens = tlc.pack_compact(*_lanes(kind, B, seed=B),
                                             pad_lanes=1)
    L, Bp = p1u16.shape
    M = tlc.max_bytes(Bp, bits_per_byte)
    before = tlc.lane_encode_streams.launches
    out, nbytes, total = tlc.lane_encode_streams(
        *tlc.from_numpy_problem(p1u16, bitw, lens, CPU), M)
    assert tlc.lane_encode_streams.launches == before
    assert out.dtype == torch.uint8 and out.shape == (L, M)
    assert nbytes.dtype == total.dtype == torch.int32
    out, nbytes, total = out.numpy(), nbytes.numpy(), total.numpy()

    pad = -L % jlc.LANES
    jout, jnb, jov, raw = jlc._lane_pipeline_jit(
        np.pad(p1u16, ((0, pad), (0, 0))), np.pad(bitw, ((0, pad), (0, 0))),
        np.pad(lens, (0, pad)), interpret=True, max_bytes=M)
    toks = [np.asarray(t)[:L] for t in raw]
    np.testing.assert_array_equal(
        total, ((toks[0] >> 16) & 3).sum(axis=1) + 2)
    overflow = bool((total > M).any())
    assert overflow == bool(jov)
    if bits_per_byte == 1:
        assert not overflow
    if bits_per_byte == 1000 and B >= 257:
        assert overflow
    if not overflow:
        np.testing.assert_array_equal(nbytes, np.asarray(jnb)[:L])
        jout = np.asarray(jout)
        got = [bytes(out[l, : nbytes[l]]) for l in range(L)]
        assert got == [bytes(jout[l, : nbytes[l]]) for l in range(L)]
        assert got == tlc.finalize_lanes(*toks, lens)
    if kind == "ffrun" and not overflow:
        # the case stresses what it claims to: 0x7F 0xFF 0xFF ... became
        # 0x80 0x00 0x00 ..., on the last lane by the flush's carry alone
        assert sum(s[:1] == b"\x80" for s in got) >= 3
        assert got[-1] == b"\x80" and toks[3][-1] == 1
        assert total[-1] > 300


@pytest.mark.parametrize("M", [0, -8, 12, 129])
def test_streams_wrapper_rejects_bad_bound(M):
    with pytest.raises(ValueError, match="multiple of 8"):
        tlc.lane_encode_streams(*_good_problem(), M)


def test_streams_wrapper_checks_the_problem_and_takes_no_lanes():
    p, w, l = _good_problem()
    with pytest.raises(TypeError):
        tlc.lane_encode_streams(p.to(torch.int32), w, l, 16)
    with pytest.raises(ValueError):
        tlc.lane_encode_streams(p.to("meta"), w.to("meta"), l.to("meta"), 16)
    out, nbytes, total = tlc.lane_encode_streams(p[:0], w[:0], l[:0], 16)
    assert out.shape == (0, 16) and nbytes.shape == total.shape == (0,)
    assert tlc.lane_collect([(0, l[:0].numpy(), out, nbytes, total,
                              (p[:0], w[:0], l[:0]))]) == []


def test_dispatch_handles_and_collect_on_cpu():
    """A pending handle is (rows, lens, out, nbytes, total, inputs); more
    rows than one group make several; collect gives every lane's bytes."""
    bitp1, lens = _lanes("carry", 64, seed=2, L=30)
    p1u16, bitw, lens = tlc.pack_compact(bitp1, lens, pad_lanes=1)
    want = tlc.finalize_lanes(*_port_tokens(bitp1, lens), lens)
    bat = tlc.LaneBatcher("cpu", 8, bits_per_byte=1)
    assert bat.add(p1u16, bitw, lens) == (0, 30)
    pending = bat.dispatch()
    assert [h[0] for h in pending] == [8, 8, 8, 6]
    for n, glens, out, nbytes, total, prob in pending:
        assert out.shape == (n, tlc.max_bytes(256, 1)) and len(glens) == n
        assert nbytes.shape == total.shape == (n,) and len(prob) == 3
    assert tlc.lane_collect(pending) == want


def test_dispatch_has_no_host_sync():
    """The only waits for the device on the lane path are in lane_collect
    (read_group): the dispatch side reads no tensor back.  (A staging
    buffer's event wait in _Staging._next or _GroupRing.take is a wait for
    an upload that read the buffer, taken only when the ring comes round to
    it.)"""
    for fn in (tlc.dispatch_traces_lanes, tlc.lane_encode_streams,
               tlc._upload, tlc._Staging.upload, tlc.dispatch_group,
               tlc.upload_group, tlc._launch, tlc.LaneBatcher.add,
               tlc.LaneBatcher.add_traces, tlc.LaneBatcher._flush,
               tlc.LaneBatcher.dispatch):
        src = inspect.getsource(fn)
        for sync in (".cpu(", ".item(", "bool(", ".tolist(", ".numpy(",
                     "synchronize("):
            assert sync not in src, (fn.__name__, sync)
    assert ".cpu()" in inspect.getsource(tlc.read_group)


def test_overflow_finalize_on_cpu():
    """Streams denser than the read-back bound (bits_per_byte=1000 makes M
    tiny) are finalized exactly on the host from the same tokens."""
    host, t = _drive(_mk(17, 2000), 512)
    bitp1, lens, _ = tlc.split_lanes([t], 512)
    expect = jlc.finalize_lanes(*jlc.lane_encode_scan(bitp1, lens), lens)
    before = tlc.lane_collect.overflows
    got = tlc.lane_streams_device(bitp1, lens, device="cpu", bits_per_byte=1000)
    assert tlc.lane_collect.overflows == before + 1
    assert got == expect
    assert tlc.encode_traces_lanes([t], 512, device="cpu")[0] == host


def test_device_finalize_path_matches_numpy():
    _, t = _drive(_mk(13, 4000), 512)
    bitp1, lens, _ = tlc.split_lanes([t], 512)
    expect = jlc.finalize_lanes(*jlc.lane_encode_scan(bitp1, lens), lens)
    before = tlc.lane_collect.overflows
    assert tlc.lane_streams_device(bitp1, lens, device="cpu") == expect
    assert tlc.lane_collect.overflows == before


@pytest.mark.parametrize("B", [64, 257, 1024])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1024, 5000])
def test_envelopes_match_host(B, n):
    host, t = _drive(_mk(B * 1000 + n, n), B)
    assert tlc.encode_traces_lanes([t], B, device="cpu")[0] == host


def test_carry_stress_envelope():
    m = RecodeModel("encode", substream_bins=128)
    t = TraceModel()
    for i in range(3000):
        bit = 1 if i % 101 else 0
        m.put_bit(("ctx", 0), bit)
        t.put_bit(("ctx", 0), bit)
    assert tlc.encode_traces_lanes([t], 128, device="cpu")[0] == m.finish()


def test_multi_trace_batch():
    traces, hosts = [], []
    for s in range(5):
        host, t = _drive(_mk(s, 700 + 631 * s), 256)
        hosts.append(host)
        traces.append(t)
    assert tlc.encode_traces_lanes(traces, 256, device="cpu") == hosts
    assert tlc.encode_traces_lanes([], 256, device="cpu") == []


@pytest.mark.parametrize("B", [256, 300])
def test_numpy_packers_match_jax(B):
    """The port's numpy copies of the packers are the JAX package's."""
    _, t = _drive(_mk(B, 2500), B)
    bitp1, lens, spans = tlc.split_lanes([t], B)
    jb, jl, js = jlc.split_lanes([t], B)
    np.testing.assert_array_equal(bitp1, jb)
    np.testing.assert_array_equal(lens, jl)
    assert spans == js
    for a, b in zip(tlc.pack_compact(bitp1, lens), jlc.pack_compact(jb, jl)):
        np.testing.assert_array_equal(a, b)
    for n in (0, (1 << 22) - 1, 1 << 22):
        assert tlc.auto_substream_bins(n) == jlc.auto_substream_bins(n)

