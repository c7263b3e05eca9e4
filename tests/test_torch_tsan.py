"""ThreadSanitizer run over the threaded paths of the port's native host
library (avrecode_tpu_torch/host/drivers/tsan_driver.cc, built by
host/Makefile's tsan_driver target): GOP-parallel compress and decompress,
threaded trace extraction in both of its forms (u64 records and the lane
form's codes), the threaded lane packer (host/src/lanepack.cc)
in both of its passes, and the window of files that
parallel/pipeline.py::device_compress_corpus runs (EXTRACT_WINDOW at once,
each extracted, packed and its handle closed on its own thread while the
files after it still extract, its rows then copied in order).  The
driver's packed rows are held to the production native.lane_pack and to
the numpy packers (split_lanes_recs + pack_p1_idx) on the same traces,
byte for byte.

The driver also runs two compress calls on two threads at once.  With
AVTPU_BILL set, both used to add to one process-wide ledger unguarded (a
data race, in the JAX package's copy too); the port's copy keeps a ledger a
call and adds it under a lock, and its printed ledger still equals the JAX
library's."""

import os
import subprocess
import sys

import numpy as np
import pytest

from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.host.native import NativeTrace
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline as tpipe

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "data")
# four clips in turn: the corpus window extracts the clips after clip k
# (EXTRACT_WINDOW of them at once) while clip k packs
CLIPS = ["mbaff_b.mkv", "rt_ctr.mkv", "cavlc_ipp.mkv", "rt_ctr.avi"]
HEAD = 10  # int64 fields before each pack's arrays (tsan_driver.cc::pack)
TSAN_ENV = {"TSAN_OPTIONS": "exitcode=66 halt_on_error=0"}


def test_make_targets_match_the_reference_and_write_under_build():
    """Every target of the JAX host Makefile has a counterpart in the
    port's, and each of the port's debug, profiling and sanitizer targets
    writes under build/torch_host/ (make -n: nothing is built)."""
    import re

    with open(os.path.join(ROOT, "avrecode_tpu", "host", "Makefile")) as f:
        ref = set(re.findall(r"^([\w.]+):", f.read(), re.M))
    assert ref - {"libavtpu.so", "clean", ".PHONY"} == set(native.TARGETS)
    for target, name in native.TARGETS.items():
        r = subprocess.run(["make", "-n", "-C", str(native._HOST), target],
                           capture_output=True, text=True, check=True)
        out = re.findall(r" -o (\S+)", r.stdout)
        assert out == [str(native.BUILD_DIR / name)], r.stdout


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def driver():
    why = native.sanitizer_missing("thread")
    if why:
        pytest.skip(f"no ThreadSanitizer runtime: {why}")
    return native.build_target("tsan_driver")


def _run(driver, tmp_path, **env):
    packs = tmp_path / "packs.bin"
    r = subprocess.run(
        [str(driver), "-w", str(tpipe.EXTRACT_WINDOW), str(packs),
         *(os.path.join(DATA, c) for c in CLIPS)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **TSAN_ENV, **env))
    assert r.returncode == 0, (
        f"tsan driver failed ({r.returncode}):\n{r.stderr[-4000:]}")
    assert "WARNING: ThreadSanitizer" not in r.stderr, r.stderr[-4000:]
    assert r.stdout.splitlines()[-1] == f"OK clips={len(CLIPS)}", r.stdout
    return r.stdout, packs.read_bytes()


@pytest.fixture(scope="module")
def run(driver, tmp_path_factory):
    return _run(driver, tmp_path_factory.mktemp("tsan"))


def _packs(blob):
    """The driver's packs: dicts of the header fields and the arrays."""
    packs, off = [], 0
    names = ("clip", "variant", "B", "Bp", "L", "form", "threads", "moved_t",
             "moved_r")
    while off < len(blob):
        head = np.frombuffer(blob, np.int64, HEAD, off)
        p = dict(zip(names, head.tolist()))
        off += 8 * HEAD
        L, Bp = p["L"], p["Bp"]
        p["bitw"] = np.frombuffer(blob, np.int32, L * Bp // 32, off).reshape(
            L, Bp // 32)
        off += 4 * L * Bp // 32
        p["lens"] = np.frombuffer(blob, np.int32, L, off)
        off += 4 * L
        if p["form"]:
            p["p1"] = np.frombuffer(blob, np.uint8, L * 3 * Bp // 2,
                                    off).reshape(L, 3 * Bp // 2)
        else:
            p["p1"] = np.frombuffer(blob, np.uint16, L * Bp, off).reshape(L, Bp)
        off += p["p1"].nbytes
        packs.append(p)
    return packs


def test_tsan_shared_buffer_packs(run):
    """Two lane packs at once into one set of buffers at disjoint row
    offsets (the index form at row 0, the u16 form after it, as the lane
    batcher points the packer at a group's fill row): no report, each
    equal to the same pack into buffers of its own."""
    out, _ = run
    shared = [ln for ln in out.splitlines() if ln.startswith("shared pack ")]
    assert len(shared) == 1 and shared[0].endswith("forms=1,0 equal"), out


def test_tsan_corpus_window(run):
    """The corpus window of device_compress_corpus, EXTRACT_WINDOW files at
    once, each extracted and packed by the threaded packer into buffers of
    its own on its thread and its handle closed there while the files
    after it still extract, the rows copied into one shared buffer in
    order by the driver's main thread, over enough files that the window
    refills: no report, and the shared buffer holds every file's rows at
    B = 4096."""
    out, blob = run
    window = tpipe.EXTRACT_WINDOW
    n_files = max(len(CLIPS), window + 2)
    rows = {p["clip"]: p["L"] for p in _packs(blob)
            if (p["B"], p["variant"]) == (4096, 0)}
    want = sum(rows[k % len(CLIPS)] for k in range(n_files))
    line = f"corpus window={window} files={n_files} rows={want}"
    assert line in out.splitlines(), out


def test_tsan_threaded_paths(run):
    """No report; every clip packed at both B and once off the squash
    image, in the form its p1 call for, and the small B on several
    threads."""
    out, blob = run
    lines = [ln for ln in out.splitlines() if ln.startswith("pack ")]
    packs = _packs(blob)
    assert len(lines) == len(packs) == 3 * len(CLIPS)
    assert {p["clip"] for p in packs} == set(range(len(CLIPS)))
    for p in packs:
        assert (p["B"], p["variant"], p["form"]) in {
            (64, 0, 1), (4096, 0, 1), (64, 1, 0)}, p
        assert p["threads"] == min(16, os.cpu_count(), -(-p["L"] // 64)), p
    assert max(p["threads"] for p in packs) >= 2, lines


@pytest.mark.parametrize("clip", range(len(CLIPS)),
                         ids=lambda k: CLIPS[k])
def test_tsan_packs_equal_python_packers(run, clip):
    """Each of the driver's packs equals native.lane_pack (the production
    library) and split_lanes_recs + pack_p1_idx (numpy) on the same traces,
    the moved p1 moved alike: form, bit words, lens and p1 or indices."""
    traces = native.extract(_read(CLIPS[clip]), "gop", want_slots=False)[3]
    for p in (p for p in _packs(run[1]) if p["clip"] == clip):
        ts = traces
        if p["variant"]:
            ts = [NativeTrace(t.recs.copy(), t.limits) for t in traces]
            recs = ts[p["moved_t"]].recs
            r = p["moved_r"]
            recs[r] = (recs[r] & np.uint64((1 << 48) - 1)) | np.uint64(2 << 48)
        B, Bp = p["B"], p["Bp"]
        prod = native.lane_pack(ts, B, Bp)
        p1u16, bitw, lens, _ = tlc.split_lanes_recs(ts, B)
        pk, ok = tlc.pack_p1_idx(p1u16, lens)
        for form, want_bitw, want_lens in ((prod[0], prod[1], prod[2]),
                                           (pk if ok else p1u16, bitw, lens)):
            assert form.dtype == p["p1"].dtype, p
            np.testing.assert_array_equal(p["p1"], form)
            np.testing.assert_array_equal(p["bitw"], want_bitw)
            np.testing.assert_array_equal(p["lens"], want_lens)


def test_tsan_bill_ledger(driver, tmp_path):
    """The same run with the bit ledger on (AVTPU_BILL): the two compress
    calls on two threads add to it without a race."""
    _run(driver, tmp_path, AVTPU_BILL="1")


@pytest.mark.parametrize("scope", ["stream", "slice"])
def test_bill_ledger_matches_reference(scope):
    """The ledger the port's library prints equals the JAX library's on a
    clip, at the scopes that keep it (gop scope keeps none)."""
    code = ("import sys; from avrecode_tpu{}.host import native; "
            "native.compress(open(sys.argv[1], 'rb').read(), scope=sys.argv[2])")
    err = []
    for pkg in ("", "_torch"):
        r = subprocess.run(
            [sys.executable, "-c", code.format(pkg),
             os.path.join(DATA, "mbaff_b.mkv"), scope],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, AVTPU_BILL="1"))
        assert r.returncode == 0, r.stderr[-2000:]
        err.append(r.stderr)
    assert "TOTAL" in err[1]
    assert err[0] == err[1]


def test_tsan_extraction_counters(run):
    """The extraction counters (avtpu_xstats), written on the GOP threads
    and read after the join, in order and without a report: after each
    clip's threaded extraction a job a GOP, and in the corpus window one
    reading a file, each on its file's thread."""
    out, _ = run
    lines = [ln.split() for ln in out.splitlines()
             if ln.startswith("xstats ")]
    codec = {ln[2]: ln[3:] for ln in lines if ln[1] == "codec"}
    assert set(codec) == {os.path.join(DATA, c) for c in CLIPS}, out
    for c in CLIPS:
        fields = dict(f.split("=") for f in codec[os.path.join(DATA, c)])
        assert int(fields["jobs"]) == native.gop_count(_read(c)), fields
        assert int(fields["slices"]) >= int(fields["jobs"])
    window = [ln for ln in lines if ln[1] == "window"]
    assert len(window) == max(len(CLIPS), tpipe.EXTRACT_WINDOW + 2), out


def test_tsan_lane_extraction(run):
    """The lane form's threaded extraction (avtpu_xopen_lane: a pass-A
    scratch a GOP thread, each GOP's codes in a mapping grown by mremap):
    no report, its counters in order with a job a GOP, the same meta and
    traces as the u64 records, every code read (bits 13-15 zero, its bin
    the record's), and the codes' count and sum those of
    native.extract_lanes."""
    out, _ = run
    lines = [ln.split() for ln in out.splitlines()]
    xstats = {ln[2]: dict(f.split("=") for f in ln[3:]) for ln in lines
              if ln[:2] == ["xstats", "lane"]}
    lane = {ln[1]: dict(f.split("=") for f in ln[2:]) for ln in lines
            if ln[0] == "lane"}
    assert set(xstats) == set(lane) == {os.path.join(DATA, c) for c in CLIPS}
    for c in CLIPS:
        data = _read(c)
        fields = xstats[os.path.join(DATA, c)]
        assert int(fields["jobs"]) == native.gop_count(data), fields
        traces = native.extract_lanes(data)[3]
        assert lane[os.path.join(DATA, c)] == {
            "traces": str(len(traces)),
            "bins": str(sum(len(t) for t in traces)),
            "sum": str(sum(int(t.codes.sum(dtype=np.uint64))
                           for t in traces))}

