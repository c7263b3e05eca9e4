"""Robustness fuzzing of the port's native host library: mutated containers
and mutated inputs through the AddressSanitizer build of its C API
(avrecode_tpu_torch/host/drivers/fuzz_harness.cc, host/Makefile's fuzz
target) must never crash or violate memory; every mutated input that
compresses must roundtrip byte for byte, and every lane its traces pack
into must hold its records' bits and p1.  The fixtures are the pinned clips
and streams, an AVI whose movi groups its chunks in nested `rec ` LISTs,
and a CAVLC clip, so that the mutants reach the AVI walk and the CAVLC
parser that the port changed.  Then mutations inside slice payloads,
through the port's codec, StreamWalker and native library, must recode or
stay literal and roundtrip through both decoders."""

import os
import random
import subprocess

import pytest

from avrecode_tpu_torch import codec
from avrecode_tpu_torch.h264.stream import StreamWalker
from avrecode_tpu_torch.host import native
from test_torch_host_faults import rec_grouped_avi

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "data")
REC_AVI = "rec_grouped.avi"  # written by the test from rec_grouped_avi()
# fixture -> harness trials
FIXTURES = {
    "rt_ctr.mp4": 30, "rt_ctr.mkv": 30, "rt_ctr.avi": 30, "rt_ctr.flv": 30,
    "rt_ctr.mpg": 30, "rt_ctr.ts": 30, "mbaff_b.mkv": 30,
    "cavlc_ipp.mkv": 40, REC_AVI: 40, "pcm_big.264": 40, "paff.264": 40,
    "mono.264": 20, "sep.264": 40, "spsi.264": 40,
}


@pytest.fixture(scope="module")
def harness():
    why = native.sanitizer_missing("address")
    if why:
        pytest.skip(f"no AddressSanitizer runtime: {why}")
    return native.build_target("fuzz")


@pytest.mark.parametrize("seed,name", list(enumerate(FIXTURES, 4242)),
                         ids=list(FIXTURES))
def test_fuzz_asan(harness, tmp_path, seed, name):
    clip = os.path.join(DATA, name)
    if name == REC_AVI:
        clip = tmp_path / name
        clip.write_bytes(rec_grouped_avi())
    r = subprocess.run(
        [str(harness), str(clip), str(seed), str(FIXTURES[name])],
        env=dict(os.environ, ASAN_OPTIONS="detect_leaks=0"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "FUZZ_OK" in r.stdout, (
        f"fuzz failed (rc={r.returncode}):\n{r.stdout}{r.stderr[-3000:]}")
    if name == REC_AVI:  # half the mutants hit a RIFF LIST header
        assert "list_header_mutants=0 " not in r.stdout, r.stdout


@pytest.mark.parametrize("name", ["rt_ctr.mkv", "cavlc_ipp.mkv"])
def test_slice_payload_mutation_fuzz(name):
    """Mutations inside slice payload byte ranges (not container boxes)
    drive the CABAC and CAVLC parsers through desync paths.  Every mutant
    must recode or fall back to literal, and roundtrip through the Python
    and the native decoder: a desync must never give silently wrong
    output."""
    with open(os.path.join(DATA, name), "rb") as f:
        base = f.read()
    spans = [(rec.offset + rec.cabac_offset, rec.offset + rec.size)
             for rec in StreamWalker(base).slices()]
    assert spans
    rng = random.Random(11)
    for _ in range(10):
        mut = bytearray(base)
        s, e = spans[rng.randrange(len(spans))]
        for _k in range(rng.randrange(1, 5)):
            i = rng.randrange(s, max(s + 1, e))
            mut[i] ^= 1 << rng.randrange(8)
        mut = bytes(mut)
        comp = native.compress(mut, scope="gop")
        assert codec.decompress(comp) == mut
        assert native.decompress(comp) == mut
