"""The port's own host layer (avrecode_tpu_torch.{codec, host.native,
models, ops tables, utils}) computes what the JAX package's computes:
containers, decoded bytes, extracted traces, envelopes and tables, on the
pinned clips at slice and gop scope.  Tolerance: exact equality (all of it
is integer arithmetic on bytes)."""

import os
import types

import numpy as np
import pytest

from avrecode_tpu import codec as jcodec
from avrecode_tpu.h264 import _cavlc_tables as jcavlc_tables
from avrecode_tpu.host import native as jnative
from avrecode_tpu.models import h264_model as jmodel
from avrecode_tpu.models import trace as jtrace
from avrecode_tpu.ops import _mix_tables as jmix
from avrecode_tpu.ops import _tables_data as jtables
from avrecode_tpu.utils import container as jcontainer
from avrecode_tpu_torch import codec as pcodec
from avrecode_tpu_torch.h264 import _cavlc_tables as pcavlc_tables
from avrecode_tpu_torch.host import native as pnative
from avrecode_tpu_torch.models import h264_model as pmodel
from avrecode_tpu_torch.models import trace as ptrace
from avrecode_tpu_torch.ops import _mix_tables as pmix
from avrecode_tpu_torch.ops import _tables_data as ptables
from avrecode_tpu_torch.utils import container as pcontainer

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CLIPS = ["rt_ctr.mkv", "rt_ctr.ts", "rt_ctr.avi", "rt_ctr.flv", "rt_ctr.mpg",
         "mbaff_b.mkv"]
CASES = [(c, s) for c in CLIPS for s in ("slice", "gop")]


def _read(clip):
    with open(os.path.join(DATA, clip), "rb") as f:
        return f.read()


def _needs_native():
    if not (jnative.available() and pnative.available()):
        pytest.skip("native library not built")


@pytest.mark.parametrize("clip, scope", CASES)
def test_codec_matches(clip, scope):
    """The Python codec: same container, and it decodes to the input."""
    data = _read(clip)
    out = pcodec.compress(data, scope=scope)
    assert out == jcodec.compress(data, scope=scope)
    assert pcodec.decompress(out) == data


def test_codec_substreams_match():
    """The v2 container (sub-stream envelopes) from both codecs."""
    data = _read(CLIPS[0])
    out = pcodec.compress(data, scope="gop", substream_bins=4096)
    assert out == jcodec.compress(data, scope="gop", substream_bins=4096)
    assert pcodec.decompress(out) == data


@pytest.mark.parametrize("clip, scope", CASES)
def test_native_matches(clip, scope):
    """The C++ mirror built from the port's host/src: same container as
    the JAX package's library, decoded by both to the input."""
    _needs_native()
    data = _read(clip)
    out = pnative.compress(data, scope=scope)
    assert out == jnative.compress(data, scope=scope)
    assert pnative.compress(data, scope=scope, threads=0) == out
    assert pnative.decompress(out) == data
    assert pnative.decompress(out, 0) == data
    assert jnative.decompress(out) == data


def _plain_blocks(blocks, traces):
    """Blocks with each trace replaced by its index in `traces`."""
    index = {id(t): i for i, t in enumerate(traces)}
    return [tuple(index.get(id(x), x) if not isinstance(x, (bytes, int, list))
                  else x for x in b) for b in blocks]


@pytest.mark.parametrize("clip, scope", CASES)
def test_extract_matches(clip, scope):
    """native.extract: parameter sets, blocks and every trace's records
    (bits, p1, pcab, slots, limits, cls), with and without the slot remap."""
    _needs_native()
    data = _read(clip)
    for want_slots in (True, False):
        p = pnative.extract(data, scope, want_slots=want_slots)
        j = jnative.extract(data, scope, want_slots=want_slots)
        assert p[0] == j[0] and p[1] == j[1]
        assert _plain_blocks(p[2], p[3]) == _plain_blocks(j[2], j[3])
        assert len(p[3]) == len(j[3]) > 0
        for pt, jt in zip(p[3], j[3]):
            assert np.array_equal(pt.bits, jt.bits)
            assert np.array_equal(pt.p1s, jt.p1s)
            assert np.array_equal(pt.pcabs, jt.pcabs)
            assert np.array_equal(pt.limits, jt.limits)
            assert np.array_equal(pt.cls, jt.cls)
            if want_slots:
                assert np.array_equal(pt.recs, jt.recs)
                assert np.array_equal(pt.slots, jt.slots)
                assert pt.recs32().shape == (len(pt), 2)
    assert pnative.gop_count(data) == jnative.gop_count(data)


def test_python_extractor_matches():
    """codec._scan_blocks with the TraceModel (the fallback extractor)."""
    data = _read(CLIPS[0])
    got, ref = [], []
    for codec, trace, out in ((pcodec, ptrace, got), (jcodec, jtrace, ref)):
        stats = {"slices": 0, "recoded": 0, "bins": 0}
        sps, pps, blocks, _ = codec._scan_blocks(
            data, pcontainer.SCOPE_SLICE, trace.TraceModel, stats, {})
        out.append(stats)
        traces = [b[6] for b in blocks if b[0] == pcontainer.KIND_SLICE]
        out.extend([sps, pps, len(blocks)])
        for t in traces:
            out.append([np.asarray(getattr(t, k)).tolist()
                        for k in ("slots", "bits", "pcabs", "p1s", "limits",
                                  "cls")])
    assert got == ref


def test_make_envelope_matches():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 300):
        streams = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8))
                   for k in rng.integers(0, 400, n)]
        assert pmodel._make_envelope(streams) == jmodel._make_envelope(streams)


def _constants(mod):
    """A module's public data: name -> comparable value."""
    out = {}
    for k, v in vars(mod).items():
        if k.startswith("__") or isinstance(v, types.ModuleType) or callable(v):
            continue
        out[k] = np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
    return out


@pytest.mark.parametrize("port, ref", [
    (pmix, jmix), (ptables, jtables), (pcavlc_tables, jcavlc_tables),
    (pcontainer, jcontainer),
], ids=["_mix_tables", "_tables_data", "_cavlc_tables", "container"])
def test_tables_match(port, ref):
    got, want = _constants(port), _constants(ref)
    assert got.keys() == want.keys() and len(got) > 0
    assert got == want


def test_model_constants_match():
    assert ptrace.N_CLS == jtrace.N_CLS == 79
    assert list(pmodel._apm_row()) == list(jmodel._apm_row())
    assert list(pmix.SQUASH) == list(jmix.SQUASH)
    assert list(pmix.STRETCH12) == list(jmix.STRETCH12)
    for k in ("HALVE_DEFAULT", "HALVE_FAST", "HALVE_SIG", "APM_RATE"):
        assert getattr(pmodel, k) == getattr(jmodel, k)


def test_library_is_keyed_on_sources_and_cpu(monkeypatch):
    """The port's libavtpu.so lives in build/torch_host under a name that
    changes with the host CPU's flags, so a -march=native library built on
    another machine is never loaded."""
    here = pnative.library_path()
    assert here.parent.name == "torch_host" and here.parent.parent.name == "build"
    assert here == pnative.library_path()
    monkeypatch.setattr(pnative, "_cpu_flags", lambda: "x86_64 another cpu")
    assert pnative.library_path() != here
