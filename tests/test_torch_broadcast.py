"""The broadcast deployment's stream class at a test size: 1080i-style
MBAFF frames (x264's interlaced=1, top field first, with the odd lines
sampled half a frame later, AVT_COMB=1), in closed GOPs with their
parameter sets, spliced into a recording as the benchmark's generator
splices its units (benchmark/harness/inputs.py::annexb_units).

  * the port's corpus main path (device_compress_corpus, gop scope, B =
    512, the plain torch coder) equals the port's codec.compress, the JAX
    package's device_compress and the benchmark's frozen reference codec,
    and device_decompress gives the recording back;
  * the native extractor's gop_field_bins counts the bins of the MB pairs
    decoded as fields, the same in each form of the extraction, and reads
    0 on progressive input."""

import functools
import os
import subprocess

import pytest

from avrecode_tpu_torch import codec, spans
from avrecode_tpu_torch.h264.params import parse_sps
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.parallel import pipeline as tpipe
from benchmark.harness.inputs import annexb_units

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "data")
GEN = os.path.join(ROOT, "tools", "genvideo")
B = 512
CLIP = "tbc_mbaff.264"
ARGS = ["176", "160", "18", "30", "6", "2", "26", "11", "1",
        "interlaced=1:tff=1:repeat-headers=1"]
ORDER = [2, 0, 1, 1]  # the units of the recording, as a seed might draw


@functools.cache
def _clip():
    """The MBAFF clip, made on first use (under a name of this process,
    then renamed: another test process may want the same file)."""
    path = os.path.join(DATA, CLIP)
    if not os.path.exists(path):
        if not os.path.exists(GEN):
            pytest.skip("tools/genvideo is not built")
        stem, ext = os.path.splitext(path)
        tmp = f"{stem}.{os.getpid()}{ext}"
        env = {k: v for k, v in os.environ.items() if k != "AVT_NOISE"}
        env["AVT_COMB"] = "1"
        subprocess.run([GEN, tmp, *ARGS], check=True, capture_output=True,
                       cwd=ROOT, env=env)
        os.replace(tmp, path)
    with open(path, "rb") as f:
        return f.read()


@functools.cache
def _recording():
    units = annexb_units(_clip())
    return b"".join(units[i] for i in ORDER)


@functools.cache
def _corpus():
    """The recording through the port's corpus main path: (container,
    stats)."""
    stats = {}
    (blob,) = tpipe.device_compress_corpus(
        [_recording()], scope="gop", substream_bins=B, device="cpu",
        stats=stats)
    return blob, stats


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


def _extraction_stats(data, form):
    """The counters of one native extraction of `data`: the lane form (the
    lane main path), the 8-byte records at gop scope on GOP threads (the
    est path), or the one pass of the slice scope."""
    stats = {}
    with spans.call("extract", stats):
        if form == "lane":
            traces = native.extract_lanes(data)[3]
        elif form == "records":
            traces = native.extract(data, scope="gop", threads=0)[3]
        else:
            traces = native.extract(data, scope="slice")[3]
    return stats, sum(len(t) for t in traces if len(t))


def test_the_clip_cuts_into_mbaff_units():
    data = _clip()
    units = annexb_units(data)
    assert len(units) == 3
    for unit in units:
        nal = unit.split(b"\x00\x00\x01")[1]  # a unit starts at its SPS
        assert nal[0] & 0x1F == 7
        sps = parse_sps(nal)
        assert sps.frame_mbs_only_flag == 0
        assert sps.mb_adaptive_frame_field_flag == 1


def test_corpus_equals_the_host_codec_jax_and_the_reference():
    from avrecode_tpu.parallel import pipeline as jpipe
    from benchmark.reference import expected

    data = _recording()
    blob, _ = _corpus()
    assert blob == codec.compress(data, scope="gop", substream_bins=B)
    assert blob == jpipe.device_compress(data, scope="gop", substream_bins=B)
    assert blob == expected.compress(data, B)


def test_device_decompress_gives_the_recording_back():
    blob, _ = _corpus()
    assert tpipe.device_decompress(blob, device="cpu") == _recording()
    assert native.decompress(blob) == _recording()


def test_corpus_stats_count_every_bin_as_mbaff():
    """Every bin of the clip lies in an MBAFF frame; those of its field
    pairs are counted, a part of the whole."""
    _, stats = _corpus()
    assert stats["bins"] > 0
    assert 0 < stats["gop_field_bins"] < stats["bins"]
    assert stats["gop_parse_s"] > 0 and stats["gop_model_s"] > 0


@pytest.mark.parametrize("form", ["lane", "records", "slice"])
def test_mbaff_counters_on_the_clip(form):
    stats, bins = _extraction_stats(_recording(), form)
    assert bins > 0
    assert 0 < stats["gop_field_bins"] < bins
    assert stats["gop_parse_s"] > 0 and stats["gop_model_s"] > 0


def test_field_bins_do_not_depend_on_the_form():
    """Every form parses the same pairs: the same field bins."""
    fields = {form: _extraction_stats(_recording(), form)[0]["gop_field_bins"]
              for form in ("lane", "records", "slice")}
    assert len(set(fields.values())) == 1, fields


@pytest.mark.parametrize("form", ["lane", "records", "slice"])
def test_mbaff_counters_are_zero_on_progressive_input(form):
    with open(os.path.join(DATA, "rt_ctr.mkv"), "rb") as f:
        data = f.read()
    stats, bins = _extraction_stats(data, form)
    assert bins > 0 and stats["gop_parse_s"] > 0
    assert stats["gop_field_bins"] == 0
