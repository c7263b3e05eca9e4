"""The port's 12-bit squash-index upload against the JAX package's: the
port's pack_p1_idx and the native one-pass lane packer
(host/native.lane_pack) against avrecode_tpu.ops.lane_coder.pack_p1_idx
and the numpy split_lanes_recs, lane_encode_streams_idx (its CPU route,
unpack_p1_idx_plain + lane_encode_streams_plain) against the JAX
_lane_pipeline_idx_jit with the Pallas kernel in interpret mode, and the
pipelines' containers against the host codec with the index form taken.
Everything here is exact integers and bytes: every comparison is byte
equality, tolerance zero.  Inputs are made from numpy seeds."""

import os

import numpy as np
import pytest
import torch

from avrecode_tpu.ops import lane_coder as jlc
from avrecode_tpu_torch import codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.host.native import NativeTrace
from avrecode_tpu_torch.models.h264_model import _make_envelope
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline as tpipe
from chip_smoke import squash_lanes

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "cavlc_ipp.mkv"]
CPU = torch.device("cpu")


@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip("native library not built")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _traces(clip, scope="gop"):
    return native.extract(_read(clip), scope, want_slots=False)[3]


def _copies(traces):
    """NativeTraces over copies of the records (safe to edit)."""
    return [NativeTrace(t.recs.copy(), t.limits) for t in traces]


def _set_p1(trace, i, p1):
    recs = trace.recs
    recs[i] = (recs[i] & np.uint64((1 << 48) - 1)) | np.uint64(p1 << 48)


def _squash_p1(seed, L=6, B=64):
    """p1 [L, B] on the squash image, zero past ragged lens (0, B among them)."""
    rng = np.random.default_rng(seed)
    sq = tlc._squash_tables()[0]
    p1 = sq[rng.integers(0, 4096, (L, B))].astype(np.uint16)
    lens = np.array([B, 0, 1, B - 1, 33, 40][:L], np.int32)
    p1[np.arange(B)[None, :] >= lens[:, None]] = 0
    return p1, lens


def test_squash_tables_are_the_jax_ones():
    for a, b in zip(tlc._squash_tables(), jlc._squash_tables()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["image", "padding", "all-padding",
                                  "foreign", "foreign-past-lens"])
def test_pack_p1_idx_matches_jax(case):
    """On the squash image (padding zeros past lens among it) the port
    packs byte for byte as the JAX package; a foreign p1 in a valid bin
    (p1 = 2, under the image's 22) refuses the index form in both.  A
    foreign value past lens is refused too: neither packer reads lens
    there, only zeros are padding."""
    p1, lens = _squash_p1(1)
    if case == "image":
        lens[:] = p1.shape[1]
        p1 = tlc._squash_tables()[0][np.arange(p1.size).reshape(p1.shape)
                                     % 4096].astype(np.uint16)
    elif case == "all-padding":
        lens[:] = 0
        p1[:] = 0
    elif case == "foreign":
        p1[0, 5] = 2
    elif case == "foreign-past-lens":
        p1[1, 5] = 2
    pk, ok = tlc.pack_p1_idx(p1, lens)
    jpk, jok = jlc.pack_p1_idx(p1)
    assert ok == jok == (case not in ("foreign", "foreign-past-lens"))
    if ok:
        assert pk.dtype == np.uint8 and pk.shape == (p1.shape[0],
                                                     3 * p1.shape[1] // 2)
        np.testing.assert_array_equal(pk, jpk)
    else:
        assert pk is None and jpk is None


def test_pack_p1_idx_refuses_a_valid_zero():
    """The one difference from the JAX function: p1 = 0 in a valid bin is
    outside the image (the JAX function would code it as SQUASH[0] = 22)."""
    p1, lens = _squash_p1(2)
    p1[0, 7] = 0
    assert jlc.pack_p1_idx(p1)[1] is True
    assert tlc.pack_p1_idx(p1, lens) == (None, False)
    lens[0] = 7  # the same zero past lens is padding
    assert tlc.pack_p1_idx(p1, lens)[1] is True


@pytest.mark.parametrize("seed", [3, 4])
def test_unpack_inverts_pack(seed):
    p1, lens = _squash_p1(seed, B=96)
    pk, ok = tlc.pack_p1_idx(p1, lens)
    assert ok
    for got in (tlc.unpack_p1_idx(torch.from_numpy(pk)),
                tlc.unpack_p1_idx_plain(torch.from_numpy(pk))):
        got = got.numpy()
        assert got.dtype == np.uint16 and got.shape == p1.shape
        live = np.arange(p1.shape[1])[None, :] < lens[:, None]
        np.testing.assert_array_equal(got[live], p1[live])
        assert (got[~live] == tlc._squash_tables()[0][0]).all()  # index 0


def test_unpack_wrapper_counts_no_launch_on_cpu_and_checks_shapes():
    before = tlc.unpack_p1_idx.launches
    tlc.unpack_p1_idx(torch.zeros((2, 48), dtype=torch.uint8))
    assert tlc.unpack_p1_idx.launches == before
    for bad in (torch.zeros((2, 47), dtype=torch.uint8),
                torch.zeros((2, 48), dtype=torch.int32),
                torch.zeros(48, dtype=torch.uint8),
                torch.zeros((2, 96), dtype=torch.uint8)[:, ::2]):
        with pytest.raises(ValueError):
            tlc.unpack_p1_idx(bad)


@pytest.mark.parametrize("B", [512, 1000, 4096, 16384])
@pytest.mark.parametrize("clip", CLIPS)
def test_native_packer_matches_numpy(needs_native, clip, B):
    """The one-pass native packer equals split_lanes_recs + pack_p1_idx on
    real native traces, the scatter path of B off the 256-bin CHUNK
    (1000) among them; native traces always take the index form."""
    traces = _traces(clip)
    Bp = -(-B // tlc.CHUNK) * tlc.CHUNK
    pk, bitw, lens, spans = native.lane_pack(traces, B, Bp)
    p1u16, qw, ql, qs = tlc.split_lanes_recs(traces, B)
    want, ok = tlc.pack_p1_idx(p1u16, ql)
    assert ok and pk.dtype == np.uint8
    np.testing.assert_array_equal(pk, want)
    np.testing.assert_array_equal(pk, jlc.pack_p1_idx(p1u16)[0])
    np.testing.assert_array_equal(bitw, qw)
    np.testing.assert_array_equal(lens, ql)
    assert spans == qs
    got = tlc.pack_lanes(traces, B)
    np.testing.assert_array_equal(got[0], pk)
    assert got[3] == spans


@pytest.mark.parametrize("p1, where", [(2, 5), (0xFFFF, -1), (0, 7)])
def test_native_packer_foreign_p1_writes_u16(needs_native, p1, where):
    """One valid bin off the squash image (under it, above it, or 0) in
    one trace: the same call writes the u16 form, equal to
    split_lanes_recs, and pack_lanes hands it on."""
    traces = _copies(_traces("rt_ctr.mkv", "slice"))
    _set_p1(traces[3], where % len(traces[3]), p1)
    got = native.lane_pack(traces, 1000, 1024)
    want = tlc.split_lanes_recs(traces, 1000)
    assert got[0].dtype == np.uint16
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    assert tlc.pack_p1_idx(want[0], want[2]) == (None, False)
    assert tlc.pack_lanes(traces, 1000)[0].dtype == np.uint16


def test_native_packer_empty_and_short_traces(needs_native):
    """Empty traces take one lane with lens 0; padding is index 0."""
    recs = _copies(_traces("rt_ctr.mkv"))[0].recs
    traces = [NativeTrace(r, np.zeros(0, np.int32))
              for r in (recs[:0], recs[:1], recs[:31], recs[:0], recs[:257])]
    pk, bitw, lens, spans = native.lane_pack(traces, 256, 256)
    assert spans == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 6)]
    np.testing.assert_array_equal(lens, [0, 1, 31, 0, 256, 1])
    p1u16, qw, ql, qs = tlc.split_lanes_recs(traces, 256)
    np.testing.assert_array_equal(pk, tlc.pack_p1_idx(p1u16, ql)[0])
    np.testing.assert_array_equal(bitw, qw)


def _jax_idx_pipeline(pk, bitw, lens, M):
    """The JAX _lane_pipeline_idx_jit (Pallas in interpret mode) on lanes
    padded to its 1,024-lane grid row: (out, nbytes, overflow, tokens)."""
    L = pk.shape[0]
    pad = -L % jlc.LANES
    out, nb, ov, raw = jlc._lane_pipeline_idx_jit(
        np.pad(pk, ((0, pad), (0, 0))), np.pad(bitw, ((0, pad), (0, 0))),
        np.pad(lens, (0, pad)), interpret=True, max_bytes=M)
    return (np.asarray(out)[:L], np.asarray(nb)[:L], bool(ov),
            [np.asarray(t)[:L] for t in raw])


def _clip_problem(B=512, rows=12):
    p1u16, bitw, lens, _ = tlc.split_lanes_recs(_traces("mbaff_b.mkv"), B)
    pk, ok = tlc.pack_p1_idx(p1u16[:rows], lens[:rows])
    assert ok
    return pk, bitw[:rows], lens[:rows]


@pytest.mark.parametrize("bits_per_byte", [1, 4, 1000])
@pytest.mark.parametrize("kind", ["random", "carry", "ffrun", "onelong",
                                  "clip"])
def test_streams_idx_matches_jax_idx_pipeline(needs_native, kind,
                                              bits_per_byte):
    """lane_encode_streams_idx on the CPU against the JAX package's
    _lane_pipeline_idx_jit in interpret mode: exact on out[l, :nbytes[l]],
    nbytes and the overflow flag; the tokens' byte counts are total."""
    if kind == "clip":
        pk, bitw, lens = _clip_problem()
    else:
        pk, bitw, lens = squash_lanes(kind, 7, 512, seed=9)
    L = pk.shape[0]
    M = tlc.max_bytes(512, bits_per_byte)
    before = tlc.lane_encode_streams_idx.launches
    out, nbytes, total = (t.numpy() for t in tlc.lane_encode_streams_idx(
        *(torch.from_numpy(a) for a in (pk, bitw, lens)), M))
    assert tlc.lane_encode_streams_idx.launches == before
    jout, jnb, jov, toks = _jax_idx_pipeline(pk, bitw, lens, M)
    np.testing.assert_array_equal(total, ((toks[0] >> 16) & 3).sum(1) + 2)
    overflow = bool((total > M).any())
    assert overflow == jov
    if bits_per_byte == 1:
        assert not overflow
    if bits_per_byte == 1000:
        assert overflow
    if not overflow:
        np.testing.assert_array_equal(nbytes, jnb)
        got = [bytes(out[l, : nbytes[l]]) for l in range(L)]
        assert got == [bytes(jout[l, : jnb[l]]) for l in range(L)]
        assert got == tlc.finalize_lanes(*toks, lens)


def test_streams_idx_wrapper_checks_the_problem():
    pk = torch.zeros((2, 96), dtype=torch.uint8)
    w = torch.zeros((2, 2), dtype=torch.int32)
    l = torch.zeros(2, dtype=torch.int32)
    assert tlc.lane_encode_streams_idx(pk, w, l, 16)[0].shape == (2, 16)
    for bad, err in (((pk.to(torch.int32), w, l), TypeError),
                     ((pk.view(torch.int16), w, l), TypeError),
                     ((pk[:, :95].contiguous(), w, l), ValueError),
                     ((pk[:, :48].contiguous(), w, l), ValueError),
                     ((pk, w[:, :1].contiguous(), l), ValueError),
                     ((pk.to("meta"), w, l), ValueError)):
        with pytest.raises(err):
            tlc.lane_encode_streams_idx(*bad, 16)
    with pytest.raises(TypeError):  # the u16 wrapper takes no indices
        tlc.lane_encode_streams(pk, w, l, 16)


def _spy_collect(monkeypatch):
    """Record the upload form of every group collect_groups drains."""
    forms = []
    real = tlc.collect_groups

    def collect(pending):
        forms.extend(str(h[5][0].dtype) for h in pending)
        return real(pending)

    monkeypatch.setattr(tlc, "collect_groups", collect)
    return forms


@pytest.mark.parametrize("clip", ["rt_ctr.mkv", "cavlc_ipp.mkv"])
def test_device_compress_takes_the_index_form(needs_native, monkeypatch,
                                              clip):
    data = _read(clip)
    forms = _spy_collect(monkeypatch)
    out = tpipe.device_compress(data, scope="gop", substream_bins=1024,
                                device="cpu")
    assert forms == ["torch.uint8"]
    assert out == codec.compress(data, scope="gop", substream_bins=1024)
    assert native.decompress(out) == data


def test_corpus_takes_the_index_form(needs_native, monkeypatch):
    datas = [_read(c) for c in CLIPS]
    forms = _spy_collect(monkeypatch)
    outs = tpipe.device_compress_corpus(datas, scope="gop",
                                        substream_bins=1024, device="cpu")
    assert forms == ["torch.uint8"]
    assert outs == [codec.compress(d, scope="gop", substream_bins=1024)
                    for d in datas]


def test_batcher_keeps_the_forms_apart(needs_native):
    """A u16 file between index files: its rows are a group of their own,
    the index rows around it groups of theirs; the streams equal each
    file's own call, row for row."""
    traces = _traces("rt_ctr.mkv", "slice")
    files = [tlc.pack_lanes(traces[:1], 256)[:3],
             tlc.split_lanes_recs(traces[1:2], 256)[:3],
             tlc.pack_lanes(traces[2:3], 256)[:3]]
    files = [tuple(a[:5] for a in f) for f in files]  # quick on the CPU
    assert [f[0].dtype for f in files] == [np.uint8, np.uint16, np.uint8]
    bat = tlc.LaneBatcher("cpu", 4)
    for f in files:
        bat.add(*f)
    got = bat.finish()
    assert [(h[5][0].dtype, h[0]) for h in bat.pending] == [
        (torch.uint8, 4), (torch.uint8, 1), (torch.uint16, 4),
        (torch.uint16, 1), (torch.uint8, 4), (torch.uint8, 1)]
    want = []
    for f in files:
        want += tlc.lane_streams_device_compact(*f, "cpu")
    assert [got.envelope(l, l + 1) for l in range(len(want))] == [
        _make_envelope([s]) for s in want]


def test_valid_zero_p1_takes_u16_and_codes_zero(needs_native):
    """p1 = 0 in a valid bin: pack_lanes gives the u16 form (a native trace
    and a Python one alike), and the lane coder codes that bin with p1 = 0
    (its range collapses and two bytes shift out), as the JAX package's u16
    pipeline does; the JAX index path would code it as SQUASH[0] = 22.  The
    host range coders take no p1 = 0 at all (they need 0 < p1 < 2^16)."""
    t = _copies(_traces("rt_ctr.mkv", "slice"))[0]
    t.recs = t.recs[:300].copy()
    _set_p1(t, 100, 0)
    p1, bitw, lens, spans = tlc.pack_lanes([t], 512)
    assert p1.dtype == np.uint16 and spans == [(0, 1)] and p1[0, 100] == 0
    assert tlc.pack_lanes([_PyTrace(t)], 512)[0].dtype == np.uint16
    got = tlc.lane_streams_device_compact(p1, bitw, lens, "cpu")
    M = tlc.max_bytes(512)
    pad = -1 % jlc.LANES
    jout, jnb, _, _ = jlc._lane_pipeline_jit(
        np.pad(p1, ((0, pad), (0, 0))), np.pad(bitw, ((0, pad), (0, 0))),
        np.pad(lens, (0, pad)), interpret=True, max_bytes=M)
    assert got == [bytes(np.asarray(jout)[0, : int(np.asarray(jnb)[0])])]
    jpk, jok = jlc.pack_p1_idx(p1)
    assert jok  # the JAX rule lets the zero through
    iout, inb, _, _ = _jax_idx_pipeline(jpk, bitw, lens, M)
    assert got != [bytes(iout[0, : inb[0]])]


class _PyTrace:
    """A Python-extracted trace's face (p1s, bits, len) over a trace."""

    def __init__(self, t):
        self.p1s, self.bits, self.n = t.p1s, t.bits, len(t)

    def __len__(self):
        return self.n


def test_overflow_fallback_unpacks_an_index_group():
    """An index-form group past the byte bound is coded again from its
    indices (unpack_p1_idx, then lane_encode) and finalized on the host."""
    pk, bitw, lens = squash_lanes("carry", 9, 256, seed=5)
    before = tlc.lane_collect.overflows
    got = tlc.lane_streams_device_compact(pk, bitw, lens, "cpu",
                                          bits_per_byte=1000)
    assert tlc.lane_collect.overflows == before + 1
    p1 = tlc.unpack_p1_idx_plain(torch.from_numpy(pk))
    toks = [x.numpy() for x in tlc.lane_encode_plain(
        p1, torch.from_numpy(bitw), torch.from_numpy(lens))]
    assert got == tlc.finalize_lanes(*toks, lens)
    assert got == jlc.finalize_lanes(*_jax_idx_pipeline(pk, bitw, lens,
                                                        16)[3], lens)
