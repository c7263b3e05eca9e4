"""Est-on-device path of the port vs the JAX package and the host codec.

The same numpy inputs, made from seeds, go through the JAX functions
(estimator_jax's XLA scans, the Pallas kernel pallas_coder._kernel in
interpret mode) and the port's plain torch versions (device="cpu").  All
arithmetic is exact integer arithmetic: every comparison is equality,
tolerance zero.  Traces stay short (the plain loop costs ~0.5-1 ms per bin
step on a CPU)."""

import os
import random
import subprocess

import jax
import numpy as np
import pytest
import torch

from avrecode_tpu import codec
from avrecode_tpu.host import native
from avrecode_tpu.models.h264_model import RecodeModel
from avrecode_tpu.models.trace import N_CLS, TraceModel
from avrecode_tpu.ops import estimator_jax as jest
from avrecode_tpu.ops import pallas_coder
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu.utils.container import SCOPE_SLICE
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import estimator as port_est
from avrecode_tpu_torch.parallel import pipeline as tpipe

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
GEN = os.path.join(ROOT, "tools", "genvideo")


def _args(seed, S, T, NS, skew=False, ncls=1, holes=False):
    """test_pallas.py's synthetic problem (seeded slots, bits, pcabs,
    ragged tail on row 0), optionally with cls over `ncls` classes, random
    halving limits and invalid bins inside the traces.  Returns
    (slots, bits, pcabs, limits, valid, cls)."""
    rng = np.random.RandomState(seed)
    slots = rng.randint(0, NS, (S, T)).astype(np.int32)
    if skew:
        bits = (rng.rand(S, T) < 0.98).astype(np.int32)
    else:
        bits = rng.randint(0, 2, (S, T)).astype(np.int32)
    pcabs = rng.randint(0, 0xFFFF, (S, T)).astype(np.int32)
    limits = np.full((S, NS), 0x60, np.int32)
    valid = np.ones((S, T), np.int32)
    valid[0, T - T // 3:] = 0  # ragged tail
    cls = np.zeros((S, NS), np.int32)
    if ncls > 1:
        cls = rng.randint(0, ncls, (S, NS)).astype(np.int32)
        limits = rng.randint(0x10, 0x100, (S, NS)).astype(np.int32)
        pcabs[:, ::3] = 0
    if holes:
        valid[:, T // 4: T // 4 + 50] = 0
        valid[-1, ::7] = 0
    return slots, bits, pcabs, limits, valid, cls


CASES = {
    "seed0": (0, 2, 200, 64),
    "seed1": (1, 2, 700, 64),
    "skew": (2, 2, 700, 64, True),
    "classes_holes": (3, 4, 1000, 300, False, N_CLS, True),
}


def _t(arrays):
    return tec.from_numpy_traces(*arrays, "cpu")


def _jax_model_probs(slots, bits, pcabs, limits, valid, cls):
    NS = limits.shape[1]
    return np.asarray(jax.vmap(
        lambda s, b, p, l, c, v: jest.model_probs(s, b, p, l, c, v, NS)
    )(slots, bits, pcabs, limits, cls, valid))


@pytest.mark.parametrize("case", ["seed1", "classes_holes"])
def test_model_probs_matches_jax(case):
    a = _args(*CASES[case])
    slots, bits, pcabs, limits, valid, cls = _t(a)
    got = port_est.model_probs(slots, bits, pcabs, limits, cls, valid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_model_probs(*a))


@pytest.mark.parametrize("scope", ["slice", "gop"])
def test_model_probs_matches_native_p1s(scope):
    """Per-bin p1 of the port's model equals the exact probability the
    native extractor recorded, on the first 3,000 bins of two real
    traces."""
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    traces = native.extract(data, scope, want_slots=True)[3][:2]
    assert len(traces) == 2
    n = 3000
    a = tpipe.pack_traces(traces)
    a = tuple(x[:, :n] for x in a[:3]) + (a[3], a[4][:, :n], a[5])
    slots, bits, pcabs, limits, valid, cls = _t(a)
    got = port_est.model_probs(slots, bits, pcabs, limits, cls, valid).numpy()
    for row, t in enumerate(traces):
        np.testing.assert_array_equal(got[row], t.p1s[:n])


@pytest.mark.parametrize("case", list(CASES))
def test_encode_slices_matches_jax(case):
    a = _args(*CASES[case])
    ref_out, ref_lens = jest.encode_slices(*a)
    out, nbytes = port_est.encode_slices(*a, device="cpu")
    for s in range(a[0].shape[0]):
        assert (port_est.stream_bytes(out[s], nbytes[s])
                == jest.stream_bytes(ref_out[s], ref_lens[s])), s


def test_encode_slices_default_class_matches_jax():
    a = _args(*CASES["seed0"])[:5]
    ref_out, ref_lens = jest.encode_slices(*a)
    out, nbytes = port_est.encode_slices(*a, device="cpu")
    assert [port_est.stream_bytes(out[s], nbytes[s]) for s in range(2)] == \
        [jest.stream_bytes(ref_out[s], ref_lens[s]) for s in range(2)]


@pytest.mark.parametrize("case", ["skew", "classes_holes"])
def test_plain_tokens_match_pallas_interpret(case, monkeypatch):
    """est_encode_plain's compacted tokens equal the Pallas kernel's
    per-chunk segments, concatenated (interpret mode, 256-bin chunks)."""
    monkeypatch.setattr(pallas_coder, "CHUNK", 256)
    seed, S, _, NS, *rest = CASES[case]
    a = _args(seed, S, 600, NS, *rest)
    toks, carrs, counts = (np.asarray(x) for x in pallas_coder._encode_raw(
        *a[:5], a[5], interpret=True))
    tok, car, count = tec.est_encode_plain(*_t(a))
    for s in range(S):
        n = counts[s]
        ref_tok = np.concatenate([toks[s, c, :n[c]] for c in range(len(n))])
        ref_car = np.concatenate([carrs[s, c, :n[c]] for c in range(len(n))])
        assert int(count[s]) == len(ref_tok)
        np.testing.assert_array_equal(tok[s, :count[s]].numpy(), ref_tok)
        np.testing.assert_array_equal(car[s, :count[s]].numpy(), ref_car)
        assert not tok[s, count[s]:].any() and not car[s, count[s]:].any()


def test_finalize_streams_matches_jax():
    """Arbitrary token segments, dense in 0xFF bytes and carries, finalize
    alike in the port and in the JAX package (Pallas host finalize and the
    XLA resolve_carries)."""
    rng = np.random.default_rng(5)
    S, W = 40, 64
    tok = np.where(rng.random((S, W)) < 0.6, 0xFF,
                   rng.integers(0, 256, (S, W))).astype(np.int32)
    car = (rng.random((S, W)) < 0.15).astype(np.int32) * rng.integers(1, 3, (S, W))
    count = rng.integers(0, W + 1, S).astype(np.int32)
    count[:3] = [0, 1, W]
    live = np.arange(W)[None, :] < count[:, None]
    tok, car = tok * live, (car * live).astype(np.int32)
    ref = pallas_coder.finalize_streams(tok[:, None], car[:, None],
                                        count[:, None])
    assert tec.finalize_streams(tok, car, count) == ref
    assert tec.finalize_streams(*map(torch.from_numpy, (tok, car, count))) == ref
    for s in range(S):
        jout, jn = jest.resolve_carries(tok[s], car[s], count[s])
        assert jest.stream_bytes(jout, jn) == ref[s]


def test_est_tables_match_jax():
    tbl, apm_row = port_est.est_tables("cpu")
    assert tbl.dtype == apm_row.dtype == torch.int32
    stretch, squash = jest._mix_tables()
    np.testing.assert_array_equal(tbl[:, 0].numpy(), np.asarray(stretch))
    np.testing.assert_array_equal(tbl[:, 1].numpy(), np.asarray(squash))
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(pallas_coder._mix_tbl()))
    np.testing.assert_array_equal(
        apm_row.numpy(), np.asarray(pallas_coder._apm_init_col())[:33, 0])
    np.testing.assert_array_equal(apm_row.numpy(), jest._apm_init())
    assert (port_est.HALVE_FAST, port_est.HIST_MAG, port_est.HIST2_MAG, port_est.APM_CELLS,
            port_est.APM_RATE, port_est.APM_HIST, port_est.N_CLS) == \
        (jest.HALVE_FAST, jest.HIST_MAG, jest.HIST2_MAG, jest.APM_CELLS,
         jest.APM_RATE, jest.APM_HIST, jest.N_CLS)


def test_est_encode_checks_its_inputs():
    a = _t(_args(*CASES["classes_holes"]))
    bad = {
        "cls": (5, lambda t: t.fill_(N_CLS), ValueError),
        "slot": (0, lambda t: t.fill_(300), ValueError),
        "bit": (1, lambda t: t.fill_(2), ValueError),
        "pcab": (2, lambda t: t.fill_(0x10000), ValueError),
        "dtype": (0, lambda t: t.long(), TypeError),
        "shape": (4, lambda t: t[:, :-1].contiguous(), ValueError),
        "strides": (1, lambda t: t.T.contiguous().T, ValueError),
    }
    for name, (k, f, exc) in bad.items():
        args = [t.clone() for t in a]
        args[k] = f(args[k])
        with pytest.raises(exc):
            tec.est_encode(*args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tec.est_encode(*(t.to("meta") for t in a))


def _host_encode(trace):
    """A TraceModel's trace through the host model coder."""
    m = RecodeModel("encode")
    inv = {v: k for k, v in trace.slot_of.items()}
    for slot, bit, pcab in zip(trace.slots, trace.bits, trace.pcabs):
        m.put_bit(inv[slot], bit, pcab if pcab else None)
    return m.finish()


def test_encode_traces_est_groups_match_host(monkeypatch):
    """Small bins budgets cut the traces into several launches, padded to
    each group's own length; streams come back in trace order, equal to
    the host model coder's."""
    rnd = random.Random(3)
    traces = []
    for n in (0, 300, 40, 900, 120, 500):
        t = TraceModel()
        keys = [("ctx", i) for i in range(30)] + [("sig", 2, i, 0, 1)
                                                  for i in range(10)]
        for _ in range(n):
            t.put_bit(rnd.choice(keys), rnd.randint(0, 1),
                      rnd.choice([None, rnd.randint(1, 0xFFFF)]))
        traces.append(t)
    host = [_host_encode(t) for t in traces]
    for budget in (1 << 27, 1200):
        monkeypatch.setattr(tec, "GROUP_BINS", budget)
        assert tec.encode_traces_est(traces, device="cpu") == host
    a = tpipe.pack_traces(traces)
    ja = jpipe.pack_traces(traces, pad_multiple=1)
    for x, y in zip(a, ja):
        np.testing.assert_array_equal(x, y)


def test_pack_traces_matches_jax():
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "mbaff_b.mkv"), "rb").read()
    traces = native.extract(data, "gop", want_slots=True)[3]
    for pad in (1, 8):
        for x, y in zip(tpipe.pack_traces(traces, pad),
                        jpipe.pack_traces(traces, pad)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert tpipe.pack_traces([]) is None


def test_device_compress_est_matches_host_and_jax():
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    port = tpipe.device_compress(data, scope="slice", substream_bins=0,
                                 device="cpu")
    assert port == codec.compress(data, scope="slice")
    assert port == native.compress(data, scope="slice")
    assert port == jpipe.device_compress(data, scope="slice", substream_bins=0)
    assert native.decompress(port) == data


def test_python_extractor_est_path(tmp_path):
    """Python-extracted traces (TraceModel) through the est path give the
    host container, on a small generated clip."""
    path = str(tmp_path / "est_tiny.mp4")
    subprocess.run([GEN, path, "96", "64", "3", "30", "3", "0", "34", "5", "2"],
                   check=True, capture_output=True)
    data = open(path, "rb").read()
    sps, pps, blocks, traces, stats = tpipe.extract_traces(
        data, use_native=False, scope="slice")
    assert stats["native"] is False and traces
    # the port extracts with its own copy of the trace model
    assert all(isinstance(t, tpipe.TraceModel) for t in traces)
    assert tpipe.TraceModel is not TraceModel
    streams = tec.encode_traces_est(traces, device="cpu")
    out = tpipe._serialize(SCOPE_SLICE, sps, pps, blocks, traces, streams, 0)
    assert out == codec.compress(data, scope="slice")
    assert codec.decompress(out) == data


def test_corpus_rejects_est_mode():
    with pytest.raises(ValueError, match="substream_bins"):
        tpipe.device_compress_corpus([b"not a video"], substream_bins=0,
                                     device="cpu")
    data = b"\x00\x00\x01 not h264" * 40
    out = tpipe.device_compress(data, scope="slice", substream_bins=0,
                                device="cpu")
    assert out == codec.compress(data, scope="slice")
