"""The program's spans and counters (avrecode_tpu_torch/spans.py), on the
CPU: parents, threads, request ids and self time; nothing recorded and
numbers only where the call is not recorded; containers unchanged by a
recording; the native extractor's counters (host/src/avtpu.cc, read by
host/native.py) on pinned clips; and the exported spans on the clock of
torch.profiler's trace."""

import json
import os
import threading
import time

import pytest
import torch

from avrecode_tpu_torch import codec, spans
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.parallel import pipeline as tpipe

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
# the third is CAVLC: its slices go through the native CAVLC parser
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "cavlc_ipp.mkv"]
B = 256
SLEEP_S = 0.02
# spans read back from the native library after its call: no profiler range
NATIVE = {"extract_walk", "gop_phase", "gop_job", "extract_stitch"}


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip("native library not built")


def test_self_time_under_nesting_and_across_threads():
    """A span's parent is the span open on its thread (a worker's first span
    the call's root), its request the call and the input index, and its
    self time its duration less its children's on its own thread only."""
    stats = {}
    with spans.recording() as rec:
        with spans.call("entry", stats, index=0):
            c = spans.current()

            def worker():
                with spans.bind(c, 3), spans.span("work"):
                    time.sleep(2 * SLEEP_S)

            with spans.span("outer"):
                t = threading.Thread(target=worker)
                t.start()
                with spans.span("inner", index=5):
                    time.sleep(SLEEP_S)
                time.sleep(SLEEP_S)
                t.join()
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"entry", "outer", "inner", "work"}
    root, outer, inner, work = (by[n] for n in ("entry", "outer", "inner",
                                                "work"))
    assert root.parent is None and outer.parent == root.id
    assert inner.parent == outer.id and work.parent == root.id
    assert len({s.call for s in rec.spans}) == 1
    assert (root.index, outer.index, inner.index, work.index) == (0, 0, 5, 3)
    assert work.tid != outer.tid == inner.tid == root.tid
    assert work.tid == t.native_id
    own = rec.self_times()
    dur = {s.name: (s.t1 - s.t0) / 1e9 for s in rec.spans}
    assert own[outer.id] == pytest.approx(dur["outer"] - dur["inner"])
    assert own[root.id] == pytest.approx(dur["entry"] - dur["outer"])
    assert own[work.id] == pytest.approx(dur["work"])
    assert own[inner.id] == pytest.approx(dur["inner"])
    assert dur["work"] >= 2 * SLEEP_S and dur["inner"] >= SLEEP_S
    # totals: every span under <name>_s; KEYS zeroed first
    for name in ("entry", "outer", "work"):
        assert stats[f"{name}_s"] == pytest.approx(dur[name], abs=1e-3)
    assert all(stats[k] == 0 for k in spans.KEYS)
    # a second call is another request
    with spans.recording() as again:
        for _ in range(2):
            with spans.call("entry"), spans.span("outer"):
                pass
    assert len({s.call for s in again.spans}) == 2


def test_no_call_bound_nothing_counted():
    """Outside a call, spans, counts and closed spans do nothing."""
    assert spans.current() is None
    with spans.span("x") as s:
        spans.count("n")
        assert spans.closed("y", 0, 1) is None
    assert s.id is None


def test_off_no_span_records_numbers_only(needs_native, monkeypatch):
    """Without a recording or a profiler: no span record and no profiler
    range is made, and every stats value is an int or a float."""
    def refuse(*a, **k):
        raise AssertionError("a span record or range was made")

    monkeypatch.setattr(spans, "Span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    datas = [_read(c) for c in CLIPS]
    for stats in ({}, None):
        tpipe.device_compress_corpus(datas, scope="gop", substream_bins=B,
                                     device="cpu", stats=stats)
    one = {}
    tpipe.device_compress(datas[0], scope="gop", substream_bins=B,
                          device="cpu", stats=one)
    corpus = {}
    tpipe.device_compress_corpus(datas, scope="gop", substream_bins=B,
                                 device="cpu", stats=corpus)
    for stats in (one, corpus):
        assert set(spans.KEYS) <= set(stats)
        assert all(type(v) in (int, float) for v in stats.values()), stats
        for k in ("extract_s", "extract_native_s", "extract_py_s",
                  "extract_release_s", "pack_s", "dispatch_s", "upload_s",
                  "collect_s", "envelope_s", "serialise_s", "gop_job_s"):
            assert stats[k] > 0, k
        assert stats["dispatches"] >= 1 and stats["bins"] > 0
    assert corpus["wait_s"] > 0 and corpus["copy_s"] > 0
    assert corpus["gop_jobs"] > one["gop_jobs"] > 0


def test_containers_equal_with_recording_on_and_off(needs_native):
    """The pinned clips through both entries: the containers with a
    recording equal those without, and the host codec's; the recording
    holds each file's worker spans under the call's root, by index."""
    datas = [_read(c) for c in CLIPS]
    want = [codec.compress(d, scope="gop", substream_bins=B) for d in datas]
    off = tpipe.device_compress_corpus(datas, scope="gop", substream_bins=B,
                                       device="cpu")
    with spans.recording() as rec:
        on = tpipe.device_compress_corpus(datas, scope="gop",
                                          substream_bins=B, device="cpu")
        one = tpipe.device_compress(datas[1], scope="gop", substream_bins=B,
                                    device="cpu")
    assert on == off == want and one == want[1]
    calls = sorted({s.call for s in rec.spans})
    assert len(calls) == 2
    corpus = [s for s in rec.spans if s.call == calls[0]]
    (root,) = [s for s in corpus if s.parent is None]
    assert root.name == "device_compress_corpus"
    extracts = [s for s in corpus if s.name == "extract"]
    assert sorted(s.index for s in extracts) == list(range(len(datas)))
    assert all(s.parent == root.id and s.tid != root.tid for s in extracts)
    waits = [s for s in corpus if s.name == "wait"]
    assert sorted(s.index for s in waits) == list(range(len(datas)))
    assert all(s.tid == root.tid for s in waits)
    assert all(s.t1 is not None for s in rec.spans)


@pytest.mark.parametrize("scope", ["gop", "slice"])
def test_native_counters(needs_native, scope):
    """The native extractor's counters on mbaff_b.mkv: at gop scope a job a
    GOP, pass A + pass B within the jobs' wall, the jobs' wall within the
    pool's, thread CPU within the jobs' wall, a walk of its own; at slice
    scope one job, no walk.  The recorded GOP jobs lie inside the native
    call's span: the library's clock is perf_counter_ns's."""
    data = _read("mbaff_b.mkv")
    stats = {}
    with spans.recording() as rec, spans.call("entry", stats):
        traces = native.extract(data, scope, threads=0, want_slots=False)[3]
    assert traces
    jobs = native.gop_count(data) if scope == "gop" else 1
    assert stats["gop_jobs"] == jobs
    assert stats["gop_slices"] >= jobs and stats["gop_slices_failed"] == 0
    assert 0 < stats["gop_parse_s"] and 0 < stats["gop_model_s"]
    assert (stats["gop_parse_s"] + stats["gop_model_s"] <= stats["gop_job_s"]
            <= stats["gop_pool_s"])
    assert 0 < stats["gop_cpu_s"] <= stats["gop_job_s"]
    assert (stats["extract_walk_s"] > 0) == (scope == "gop")
    assert stats["extract_stitch_s"] > 0 and stats["extract_py_s"] > 0
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    (native_span,) = by["extract_native"]
    (phase,) = by["gop_phase"]
    assert len(by["gop_job"]) == jobs
    for s in by["extract_walk"] + [phase] + by["gop_job"] + by[
            "extract_stitch"]:
        assert native_span.t0 <= s.t0 <= s.t1 <= native_span.t1
    assert all(s.parent == phase.id for s in by["gop_job"])
    assert sum(s.t1 - s.t0 for s in by["gop_job"]) / 1e9 == pytest.approx(
        stats["gop_job_s"])


def test_exported_spans_on_the_profilers_clock(needs_native, tmp_path):
    """Under torch.profiler.profile (CPU), a call's exported main-thread
    spans and the profiler's ranges of the same spans agree within 1 ms,
    start and duration; worker spans and the native library's spans are in
    the export and not in the profiler's trace."""
    datas = [_read(c) for c in CLIPS[:2]]
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with spans.recording() as rec:
            tpipe.device_compress(datas[0], scope="gop", substream_bins=B,
                                  device="cpu")
            tpipe.device_compress_corpus(datas, scope="gop",
                                         substream_bins=B, device="cpu")
    prof_path, ours_path = tmp_path / "prof.json", tmp_path / "ours.json"
    prof.export_chrome_trace(str(prof_path))
    rec.export(str(ours_path))
    trace = json.loads(prof_path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault((e["name"], e["tid"]), []).append(e)
    ours = json.loads(ours_path.read_text())["traceEvents"]
    main = threading.get_native_id()
    compared = 0
    for e in ours:
        key = (e["name"], e["tid"])
        if e["tid"] != main or e["name"] in NATIVE:
            assert key not in ranges
            continue
        near = min(ranges[key], key=lambda r: abs(r["ts"] + base_us - e["ts"]))
        assert abs(near["ts"] + base_us - e["ts"]) < 1000, e
        assert abs(near["dur"] - e["dur"]) < 1000, e
        compared += 1
    names = {e["name"] for e in ours if e["tid"] == main}
    assert {"device_compress", "device_compress_corpus", "extract_native",
            "wait", "serialise", "collect"} <= names
    assert compared >= 10
    assert any(e["name"] == "gop_job" and e["tid"] != main for e in ours)
