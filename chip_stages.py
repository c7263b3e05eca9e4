#!/usr/bin/env python3
"""Where the time goes in the port's device paths, stage by stage, on one
GPU.

    python3 chip_stages.py [PART...]   # from the repository root, one CUDA card

Each stage is timed on the host clock with a synchronize after it, the
least of three runs; the whole call is timed the same way, and once more
under torch.profiler for the device's busy time (the sum over kernels,
copies and fills; idle share = 1 - busy / wall, an underestimate where a
copy overlaps a kernel).  Not a benchmark: no spread, small pinned clips.
The parts, all of them by default, in this order:

  est        device_compress(data, scope, substream_bins=0) on rt_ctr.mkv
             and mbaff_b.mkv at slice and gop scope: extract, pack, upload,
             range check, zero fill, kernel, read-back, finalize, container
  pack       the clips' real gop traces replicated to a full [8192, 16384]
             group: the numpy packer (split_lanes_recs, then pack_p1_idx for
             the index form) and the native one (host/native.lane_pack; its
             u16 form where a p1 leaves the squash image, here one at the
             group's first bin)
  group      the host side of that group on the main path: the traces as
             ~100 files packed straight into the group's staging buffer
             (LaneBatcher.add_traces), the upload from it, the kernel, the
             read-back and the envelopes cut from it by offset
  lane       lane_streams_device_compact on one full dispatch group
             [8192, 16384] tiled from the clips' real traces, in both upload
             forms (u16 p1, and 12-bit squash indices from the native
             packer): upload (the numpy rows through the 32 MiB staging
             ring, _upload), kernel (lane_encode_streams /
             lane_encode_streams_idx), read-back, slicing
  corpus     device_compress_corpus on chip_smoke.py phase 15's corpus (the
             13 pinned files x ~158 copies) at B = 16384 and 4096, three
             passes each, each pass's host time by stage as the program's
             own spans and counters give it in its stats (those the tree
             has; avrecode_tpu_torch/spans.py): on the main thread the wait
             on the extractions, the copy of the packed rows in, upload,
             launch, read-back, envelopes, serialisation and the rest of
             the wall; on the worker threads, summed over them, the
             extraction and its parts (the native walk, GOP jobs and
             stitch, the Python around them, the traces' release) and the
             lane pack; the process's CPU time over the pass (all threads)
             and the cores it kept busy; the pass's peak RSS (VmRSS
             sampled on a thread) and its peak device memory
             (torch.cuda.max_memory_allocated above what was allocated
             before it)
  window     the same corpus at B = 16384, at each extraction window of
             WINDOWS and each extraction's GOP threads of GOP_THREADS, then
             at each EXTRACT_BYTES of BYTES_SWEEP (trees that have it) at
             the tree's window, two passes each, split as above
  benchcorpus  the bench's own corpus (bench.CORPUS and CONFORMANCE under
             data/; raises naming any missing) at the bench's B, three
             passes split as above, in a fresh process for the tree's
             EXTRACT_BYTES and one for each of BENCH_BYTES (trees that
             have it): each pass's wall, peak RSS and the RSS before it,
             and the process's ru_maxrss (the bench's max_rss_mb)
  bigcorpus  the same for BIG_CORPUS, five long HD clips of 20-33 MB, each
             above the tree's EXTRACT_BYTES (make_big_corpus makes them
             where libx264 is; raises naming any missing), at each of
             BIG_BYTES, BIG_RUNS passes a process
  copy       the main thread's copy of phase 15's packed rows into a
             pinned group (LaneBatcher.add), by each way of COPY_WAYS, a
             file a call and one call for all, on an idle host and beside
             EXTRACT_WINDOW extracting threads: wall and thread CPU
  route      one file into a dispatch group both ways, add_traces (packed
             in place) and pack_lanes then add (copied in), the stage
             alone and device_compress whole, on ROUTE_FILES at ROUTE_BS
  transfer   the ways to bring the group's p1 (268 MB) to the card, and the
             parts of the read-back
  decode     device_decompress(blob) on containers of rt_ctr.mkv and
             mbaff_b.mkv at gop scope, v2 (B = 4096) and v1: host model
             pass, pack, upload, kernel, read-back, split, host assembly
  unpack     the archive cell's est group (chip_smoke.archive_group: the
             benchmark's four camera GOPs at gop scope, repeated to 48
             GOP-long traces), brought to the card both ways, pack_rows and
             its upload against the slot tables, the records' upload and
             est_unpack (each stage and _records_problem whole), equal
             rows; then est_unpack's launch alone by CUDA events beside
             its bound and its plain version on the card
  archive    the archive cell's recordings: the four camera GOPs
             repeated to each of ARCHIVE_GOPS, device_compress(scope="gop",
             substream_bins=0) once warm and ARCHIVE_RUNS times with
             stats, each run's wall, its est stage by the program's spans
             and counters (those the tree has), the est kernel's launches,
             traces a launch and groups cut by the card's memory, its peak
             RSS and device peak; every container equal to the first;
             then the longest recording's group (chip_smoke.archive_group)
             through the est kernel alone, with each stage's waits (the
             tiles on which the rows stage found its ring to the mixer
             full, and the mixer, APM and coder their input ring empty):
             the stage that sets the pace
"""

import os
import resource
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from avrecode_tpu_torch import bench, codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.models.h264_model import _make_envelope
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline
from avrecode_tpu_torch.utils.container import SCOPE_GOP, SCOPE_SLICE
from chip_smoke import (
    BENCH_GROUPS, BENCH_SET, CLIPS, FULL_B, FULL_L, ROOT, PeakRSS,
    archive_group, bound_ms, card_line, cuda_ms, decompress_stages,
    group_ring_bytes, lane_stage_split, log, phase_est_archive, tiled_problem,
    tiled_trace)

RUNS = 3
ARCHIVE_GOPS = (24, 48, 32, 40)  # the archive cell's recordings, in GOPs
ARCHIVE_RUNS = 2
EST_KEYS = ("extract_s", "est_pack_s", "est_upload_s", "est_launch_s",
            "est_collect_s", "est_finalize_s", "est_wait_s", "serialise_s",
            "est_launches", "est_traces", "est_memory_cuts",
            "est_padded_bins", "bins")
CORPUS_BS = (16384, 4096)  # the corpus split's B: the bench's, and ~8 groups
WINDOWS = (1, 2, 4, 8, 16)  # extraction windows of the `window` part
GOP_THREADS = (0, 1)  # an extraction's GOP threads in the `window` part
WINDOW_RUNS = 2
# EXTRACT_BYTES of the `window` part (phase 15's files are 270 B to 33 KB)
BYTES_SWEEP = (64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
# EXTRACT_BYTES of the `benchcorpus` part, each in a process of its own (its
# files are 1.5 KB to 5.7 MB); 1 << 40 bounds nothing
BENCH_BYTES = (2 << 20, 4 << 20, 8 << 20, 16 << 20, 1 << 40)
# A directory of long HD clips, each larger than EXTRACT_BYTES: bench.CORPUS
# entries (tools/genvideo arguments), made under data/ by make_big_corpus()
# on a host with libx264 (the card's machine has none) and carried untracked
BIG_CORPUS = [
    ("big_1080p_gop60.mp4", 1920, 1080, 2400, 30, 60, 2, 18, 1101, 1),
    ("big_1080p_gop250.mp4", 1920, 1080, 1800, 30, 250, 3, 18, 1102, 1),
    ("big_1080p_crf20.mp4", 1920, 1080, 3000, 30, 60, 2, 20, 1103, 1),
    ("big_720p.mp4", 1280, 720, 3600, 30, 60, 2, 18, 1104, 1),
    ("big_4k.mp4", 3840, 2160, 600, 30, 60, 2, 20, 1105, 4),
]
BIG_ENV = {"AVT_NOISE": "4"}  # genvideo's content knob, every big clip
# EXTRACT_BYTES of the `bigcorpus` part, each in a process of its own
BIG_BYTES = (8 << 20, 32 << 20, 64 << 20, 128 << 20, 1 << 40)
BIG_RUNS = 2


class Stages:
    """Least time of each named stage over the runs, in ms."""

    def __init__(self):
        self.best = {}

    def time(self, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        self.best[name] = min(ms, self.best.get(name, ms))
        return out

    def line(self):
        return ", ".join(f"{k} {v:.2f}" for k, v in self.best.items())


def device_busy_ms(fn):
    """(wall ms, device busy ms) of one profiled call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernels, copies and fills only: a host-side op also carries the time
    # of the kernels it launched, which would count them twice
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy


def est_stages(dev, clip, scope):
    with open(os.path.join(ROOT, "data", clip), "rb") as f:
        data = f.read()
    st = Stages()
    for _ in range(RUNS):
        sps, pps, blocks, traces, stats = st.time(
            "extract", lambda: pipeline.extract_traces(
                data, scope=scope, want_slots=True))
        if not stats["native"]:
            raise RuntimeError("the native extractor did not run")

        def pack():
            order = sorted(range(len(traces)), key=lambda i: len(traces[i]))
            ts = [traces[i] for i in order]
            T = max(len(t) for t in ts)
            NS = max(len(t.limits) for t in ts)
            return order, tec.pack_rows(ts, len(ts), T, NS)

        order, arrays = st.time("pack", pack)
        prob = st.time("upload", lambda: tec.from_numpy_traces(*arrays, dev))
        st.time("check", lambda: tec._check_problem(*prob))
        S, T = prob[0].shape

        def fill():
            tok = torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=dev)
            return tok, torch.zeros_like(tok), torch.zeros(
                S, dtype=torch.int32, device=dev)

        tok, car, count = st.time("fill", fill)
        st.time("kernel", lambda: tec._launch(*prob, tok, car, count))

        def read_back():
            c = count.cpu()
            M = int(c.max())
            return tok[:, :M].cpu(), car[:, :M].cpu(), c

        host = st.time("read-back", read_back)
        streams = [None] * len(traces)
        for i, s in zip(order, st.time(
                "finalize", lambda: tec.finalize_streams(*host))):
            streams[i] = s
        scope_id = SCOPE_SLICE if scope == "slice" else SCOPE_GOP
        out = st.time("container", lambda: pipeline._serialize(
            scope_id, sps, pps, blocks, traces, streams, 0))
        whole = st.time("device_compress", lambda: pipeline.device_compress(
            data, scope=scope, substream_bins=0, device=dev))
        if out != whole:
            raise RuntimeError("the staged run and device_compress differ")
    wall, busy = device_busy_ms(lambda: pipeline.device_compress(
        data, scope=scope, substream_bins=0, device=dev))
    log(f"est stages {clip} {scope} ({len(traces)} traces, longest "
        f"{max(map(len, traces))} bins), ms: {st.line()}; profiled call "
        f"{wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
        f"{1 - busy / wall:.1%}")


def lane_stages(dev):
    p1u16, bitw, lens = tiled_problem(CLIPS, FULL_L, FULL_B)
    p1pk = tlc.pack_lanes([tiled_trace(CLIPS, FULL_L, FULL_B)], FULL_B)[0]
    want = None
    for form, p1 in (("u16", p1u16), ("index", p1pk)) * 2:
        tlc.lane_streams_device_compact(p1, bitw, lens, dev)  # pinned buffers
        best, parts = lane_stage_split(dev, p1, bitw, lens, RUNS)
        st = Stages()
        st.best = best
        for _ in range(RUNS):
            whole = st.time("lane_streams_device_compact", lambda:
                            tlc.lane_streams_device_compact(p1, bitw, lens,
                                                            dev))
            if parts != whole or (want is not None and whole != want):
                raise RuntimeError("the staged run, the whole call or the "
                                   "two forms differ")
            want = whole
        wall, busy = device_busy_ms(
            lambda: tlc.lane_streams_device_compact(p1, bitw, lens, dev))
        log(f"lane stages [{FULL_L}, {FULL_B}], {form} form, ms: "
            f"{st.line()}; profiled call {wall:.2f} ms wall, device busy "
            f"{busy:.2f} ms, idle {1 - busy / wall:.1%}")


def replicated_traces(clips, L, B):
    """The clips' gop traces, repeated in order until their lanes fill L
    rows of B bins exactly (the last one cut short), and the extracted
    traces they view (kept alive by the caller)."""
    owners = []
    for c in clips:
        with open(os.path.join(ROOT, "data", c), "rb") as f:
            owners += native.extract(f.read(), "gop", want_slots=False)[3]
    out, rows = [], 0
    while rows < L:
        for t in owners:
            k = max(1, -(-len(t) // B))
            if rows + k > L:
                k = L - rows
                t = native.NativeTrace(t.recs[: k * B], t.limits)
            out.append(t)
            rows += k
            if rows == L:
                break
    return out, owners


def lane_pack_stage(dev):
    """The lane pack stage on a full group of real traces, both packers
    and both forms."""
    traces, owners = replicated_traces(CLIPS, FULL_L, FULL_B)
    n_bins = sum(map(len, traces))
    # the same traces with one p1 off the squash image, at the first bin
    first = native.NativeTrace(traces[0].recs.copy(), traces[0].limits)
    first.recs[0] = (first.recs[0] & np.uint64((1 << 48) - 1)) | np.uint64(
        2 << 48)
    foreign = [first] + traces[1:]
    st = Stages()
    out = {}
    for _ in range(RUNS):
        out["numpy u16"] = st.time("numpy split_lanes_recs (u16)",
                                   lambda: tlc.split_lanes_recs(traces,
                                                                FULL_B))
        p1u16, _, lens, _ = out["numpy u16"]
        out["numpy index"] = st.time(
            "numpy pack_p1_idx on top (index)",
            lambda: tlc.pack_p1_idx(p1u16, lens))
        out["native index"] = st.time(
            "native lane_pack (index)",
            lambda: native.lane_pack(traces, FULL_B, FULL_B))
        out["native u16"] = st.time(
            "native lane_pack (u16, a foreign p1 at the first bin)",
            lambda: native.lane_pack(foreign, FULL_B, FULL_B))
    p1u16, bitw, lens, spans = out["numpy u16"]
    p1pk = out["numpy index"][0]
    nat = out["native index"]
    if (p1u16.shape[0] != FULL_L or nat[0].dtype != np.uint8
            or not np.array_equal(nat[0], p1pk)
            or not np.array_equal(nat[1], bitw) or nat[3] != spans
            or out["native u16"][0].dtype != np.uint16):
        raise RuntimeError("the packers disagree")
    fu16 = tlc.split_lanes_recs(foreign, FULL_B)[0]
    if not np.array_equal(out["native u16"][0], fu16):
        raise RuntimeError("the native u16 form differs from numpy's")
    del out, fu16, foreign, first
    log(f"lane pack [{FULL_L}, {FULL_B}] ({len(traces)} real gop traces, "
        f"{n_bins} bins, {torch.get_num_threads()} host threads), ms, least "
        f"of {RUNS}: {st.line()}; ns a bin: "
        + ", ".join(f"{v * 1e6 / n_bins:.2f}" for v in st.best.values()))

    del owners


def group_stages(dev):
    """The host side of one full dispatch group on the main path, stage by
    stage, a synchronize after each: the clips' real gop traces, as ~100
    files, packed straight into the group's staging buffer
    (LaneBatcher.add_traces), the upload from it, the kernel, the
    read-back and the envelopes cut from it by offset; the envelopes equal
    _make_envelope's of lane_streams_device_compact's streams."""
    traces, owners = replicated_traces(CLIPS, FULL_L, FULL_B)
    cuts = np.linspace(0, len(traces), 101).astype(int)
    files = [traces[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    M = tlc.max_bytes(FULL_B)
    st = Stages()
    for _ in range(RUNS):
        # one group that does not dispatch itself: its stages apart
        bat = tlc.LaneBatcher(dev, FULL_L + 1)
        placed = st.time("pack into the group buffer", lambda: [
            bat.add_traces(f, FULL_B) for f in files])
        group, n = bat.group, bat.acc
        bat.group, bat.acc = None, 0
        prob = st.time("upload", lambda: tlc.upload_group(group, n, dev))
        code = (tlc.lane_encode_streams_idx if group.index
                else tlc.lane_encode_streams)
        got = st.time("kernel", lambda: code(*prob, M))
        back = st.time("read-back", lambda: tlc.read_group(n, *got))
        envs = st.time("envelopes", lambda: envelopes(back, placed))
    p1, bitw, lens, spans = tlc.pack_lanes(traces, FULL_B)
    streams = tlc.lane_streams_device_compact(p1, bitw, lens, dev)
    if n != FULL_L or envs != [_make_envelope(streams[a:b])
                               for a, b in spans]:
        raise RuntimeError("the group's envelopes differ from "
                           "lane_streams_device_compact's")
    log(f"group stages [{FULL_L}, {FULL_B}], {len(files)} files, "
        f"{len(traces)} traces, form {'index' if group.index else 'u16'}, "
        f"ms, least of {RUNS}: {st.line()}; host side (all but the kernel) "
        f"{sum(st.best.values()) - st.best['kernel']:.2f}; "
        f"{group_ring_bytes()}")
    del owners


def envelopes(back, placed):
    """Every trace's envelope, cut by offset from one group's read-back."""
    got = tlc.GroupStreams([back])
    return [got.envelope(lo + a, lo + b)
            for (lo, _), spans in placed for a, b in spans]


def phase15_corpus():
    """chip_smoke.py phase 15's corpus: the pinned files (BENCH_SET), as
    many copies as pass BENCH_GROUPS full dispatch groups at the bench's B
    (the count chip_smoke.phase_bench takes)."""
    datas = [open(os.path.join(ROOT, "data", n), "rb").read()
             for n in BENCH_SET]
    rows = sum(tlc.pack_lanes(pipeline.extract_traces(
        d, scope="gop", want_slots=False)[3], bench.CORPUS_B)[0].shape[0]
        for d in datas)
    return datas, BENCH_GROUPS * tlc.GROUP_ROWS // rows + 1


# the program's stats (spans.KEYS) that are main-thread stages of a
# corpus pass, the rest of the pass's wall being the time outside them
MAIN_STAGES = ("wait_s", "copy_s", "dispatch_s", "collect_s", "envelope_s",
               "serialise_s")


def split_pass(corpus, B, dev, window=None, threads=None, budget=None):
    """One device_compress_corpus pass split by stage from the program's
    own stats (its spans and counters; a tree before them gives what its
    stats hold): (containers, stats, {stage: s}) with the stats' seconds
    (the workers' summed over them), the launch (dispatch less upload),
    the rest of the wall (the wall less the main thread's stages), the
    wall, the process's CPU time and cores busy, the pass's peak RSS and
    its device peak (bytes above what was allocated before it).  window
    sets pipeline.EXTRACT_WINDOW, budget pipeline.EXTRACT_BYTES (trees that
    have it), threads each extraction's GOP threads (0 = the extractor's
    own count), for the pass."""
    originals = [(pipeline, "extract_traces", pipeline.extract_traces)]
    if window is not None:
        originals.append((pipeline, "EXTRACT_WINDOW", pipeline.EXTRACT_WINDOW))
    if budget is not None:
        originals.append((pipeline, "EXTRACT_BYTES", pipeline.EXTRACT_BYTES))
    stats = {}
    try:
        if threads is not None:
            def extract(data, real=pipeline.extract_traces, **kw):
                return real(data, **dict(kw, threads=threads))
            pipeline.extract_traces = extract
        if window is not None:
            pipeline.EXTRACT_WINDOW = window
        if budget is not None:
            pipeline.EXTRACT_BYTES = budget
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        allocated = torch.cuda.memory_allocated(dev)
        with PeakRSS() as rss:
            t0, c0 = time.perf_counter(), time.process_time()
            outs = pipeline.device_compress_corpus(
                corpus, scope="gop", substream_bins=B, device=dev,
                stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            host_cpu = time.process_time() - c0
        device_peak = torch.cuda.max_memory_allocated(dev) - allocated
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
    spent = {k: v for k, v in stats.items() if k.endswith("_s")}
    if "dispatch_s" in spent:
        spent["launch_s"] = spent["dispatch_s"] - spent["upload_s"]
    spent["the rest"] = wall - sum(spent.get(k, 0.0) for k in MAIN_STAGES)
    spent["wall"] = wall
    spent["host CPU, all threads"] = host_cpu
    spent["cores busy"] = host_cpu / wall
    spent["peak RSS GB"] = rss.peak / 1e9
    spent["RSS before GB"] = rss.before / 1e9
    spent["device peak GB"] = device_peak / 1e9
    return outs, stats, spent


def median_line(passes):
    """Each key's median over the passes, then every pass's value."""
    names = list(dict.fromkeys(k for p in passes for k in p))
    return "; ".join(
        f"{n} {np.median([p.get(n, 0.0) for p in passes]):.4f} ("
        + ", ".join(f"{p.get(n, 0.0):.4f}" for p in passes) + ")"
        for n in names)


def corpus_passes(corpus, B, dev, runs, **kw):
    """`runs` split passes (split_pass); every pass's containers equal the
    first's.  Returns (stats, [spent])."""
    passes, first = [], None
    for _ in range(runs):
        outs, stats, spent = split_pass(corpus, B, dev, **kw)
        if first is not None and outs != first:
            raise RuntimeError("corpus: a pass's containers differ")
        first = outs
        passes.append(spent)
    return stats, passes


def corpus_split(dev):
    """device_compress_corpus on phase 15's corpus at each B of CORPUS_BS,
    RUNS passes each, split by stage (split_pass); every pass's containers
    equal the first's."""
    datas, copies = phase15_corpus()
    corpus = datas * copies
    for B in CORPUS_BS:
        stats, passes = corpus_passes(corpus, B, dev, RUNS)
        log(f"corpus split B={B}: {len(corpus)} files ({copies} copies of "
            f"{len(datas)}), {stats['bins']} bins, {stats['dispatches']} "
            f"dispatches, window {getattr(pipeline, 'EXTRACT_WINDOW', 1)}; "
            f"s a pass, median of {RUNS} (each pass): {median_line(passes)}")


def tree_budget():
    """The tree's EXTRACT_BYTES, as text ("none" before the window had a
    byte bound)."""
    return str(getattr(pipeline, "EXTRACT_BYTES", "none"))


def corpus_window(dev):
    """device_compress_corpus on phase 15's corpus at the bench's B, at
    each extraction window of WINDOWS and each extraction's GOP threads of
    GOP_THREADS (0: the extractor's own count, up to 16), then at each
    EXTRACT_BYTES of BYTES_SWEEP at the tree's window and GOP threads (in
    trees that have it), WINDOW_RUNS passes each (split_pass)."""
    datas, copies = phase15_corpus()
    corpus = datas * copies
    sizes = sorted(map(len, datas))
    log(f"corpus window: {len(corpus)} files of {sizes[0]}-{sizes[-1]} "
        f"bytes; the tree's window {pipeline.EXTRACT_WINDOW}, EXTRACT_BYTES "
        f"{tree_budget()}")
    runs = [(window, threads, None) for threads in GOP_THREADS
            for window in WINDOWS]
    if hasattr(pipeline, "EXTRACT_BYTES"):
        runs += [(None, None, budget) for budget in BYTES_SWEEP]
    for window, threads, budget in runs:
        stats, passes = corpus_passes(corpus, bench.CORPUS_B, dev,
                                      WINDOW_RUNS, window=window,
                                      threads=threads, budget=budget)
        log(f"corpus window={window or pipeline.EXTRACT_WINDOW} "
            f"threads={threads or 0} bytes={budget or tree_budget()} "
            f"B={bench.CORPUS_B} ({os.cpu_count()} cores): "
            f"{stats['dispatches']} dispatches; s a pass, median of "
            f"{WINDOW_RUNS} (each pass): {median_line(passes)}")


def corpus_paths(names, what):
    """data/<name> for each name; raises naming every one that is missing
    (tools/genvideo makes the x264 clips, and cannot run on the card's
    machine)."""
    missing = [n for n in names
               if not os.path.exists(os.path.join(ROOT, "data", n))]
    if missing:
        raise RuntimeError(f"{what}: {len(missing)} files missing "
                           f"from data/: {', '.join(missing)}")
    return [os.path.join(ROOT, "data", n) for n in names]


def bench_paths():
    """The bench's own corpus files (bench.CORPUS, then CONFORMANCE)."""
    return corpus_paths([name for name, *_ in bench.CORPUS + bench.CONFORMANCE],
                        "bench corpus")


def big_paths():
    """The clips of BIG_CORPUS (make_big_corpus makes them)."""
    return corpus_paths([name for name, *_ in BIG_CORPUS], "big corpus")


CORPORA = {"bench": (bench_paths, RUNS), "big": (big_paths, BIG_RUNS)}


def corpus_child(which, budget):
    """In a fresh process: warm up, then the corpus's split passes
    (CORPORA: its paths and passes) at the bench's B with EXTRACT_BYTES =
    budget (None: the tree's), each pass's line and then the process's
    ru_maxrss."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    find, runs = CORPORA[which]
    paths = find()
    warm_up(dev)
    passes = []
    for i in range(runs):
        outs, stats, spent = split_pass(paths, bench.CORPUS_B, dev,
                                        budget=budget)
        del outs
        passes.append(spent)
        log(f"{which} corpus pass {i + 1} bytes={budget or tree_budget()}: "
            f"wall {spent['wall']:.4f} s, peak RSS {spent['peak RSS GB']:.3f}"
            f" GB ({spent['RSS before GB']:.3f} GB before), cores busy "
            f"{spent['cores busy']:.2f}, {stats['dispatches']} dispatches, "
            f"{stats['bins']} bins")
    sizes = sorted(map(os.path.getsize, paths))
    log(f"{which} corpus bytes={budget or tree_budget()}: {len(paths)} files "
        f"of {sizes[0]}-{sizes[-1]} bytes, {sum(sizes)} in all, window "
        f"{pipeline.EXTRACT_WINDOW}; s a pass, median of {runs} (each pass):"
        f" {median_line(passes)}; ru_maxrss "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.1f} MB")


def corpus_children(which, budgets):
    """corpus_child in a process of its own for the tree's EXTRACT_BYTES,
    then for each of `budgets` (trees that have it): a process's peak RSS
    is what the bench reads, and glibc keeps what a pass frees, so budgets
    are not compared within one process."""
    CORPORA[which][0]()
    todo = [None]
    if hasattr(pipeline, "EXTRACT_BYTES"):
        todo += [b for b in budgets if b != pipeline.EXTRACT_BYTES]
    for budget in todo:
        res = subprocess.run(
            [sys.executable, "-c", "import chip_stages; "
             f"chip_stages.corpus_child({which!r}, {budget})"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=900)
        for line in res.stdout.splitlines():
            if line.startswith(f"{which} corpus"):
                log(line)
        if res.returncode != 0:
            raise RuntimeError(f"{which} corpus bytes={budget}: exit code "
                               f"{res.returncode}\n{res.stderr[-3000:]}")


def bench_corpus(dev):
    corpus_children("bench", BENCH_BYTES)


def big_corpus(dev):
    corpus_children("big", BIG_BYTES)


def _numpy_put(group, r0, p1, bitw, lens):
    """_Group.put through numpy's assignment: the GIL released for each
    array's copy."""
    for dst, src in zip(group.np, (p1, bitw, lens)):
        dst[r0:r0 + src.shape[0]] = src


def _memmove_put(group, r0, p1, bitw, lens):
    """_Group.put through ctypes.memmove: one memcpy an array, the GIL
    released for each."""
    import ctypes
    for dst, src in zip(group.np, (p1, bitw, lens)):
        src = np.ascontiguousarray(src)
        ctypes.memmove(dst[r0:].ctypes.data, src.ctypes.data, src.nbytes)


COPY_WAYS = {"_Group.put (the GIL held under HOLD_GIL_BYTES)": tlc._Group.put,
             "numpy, the GIL released": _numpy_put,
             "ctypes.memmove, the GIL released": _memmove_put}


class _Load:
    """EXTRACT_WINDOW threads extracting the given files over and over (the
    native extractor, the GIL released, its GOP threads), as the corpus
    pass's workers load the host while the main thread copies."""

    def __init__(self, datas):
        self.datas, self.stop = datas, threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(k,),
                                         daemon=True)
                        for k in range(pipeline.EXTRACT_WINDOW)]

    def _run(self, k):
        while not self.stop.is_set():
            pipeline.extract_traces(self.datas[k % len(self.datas)],
                                    scope="gop", want_slots=False)
            k += 1

    def __enter__(self):
        for t in self.threads:
            t.start()
        time.sleep(1.0)
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join()


def copy_split(dev):
    """What the main thread's copy of a phase-15 pass's packed rows costs
    (LaneBatcher.add's _Group.put): every file's rows packed by pack_lanes
    into arrays of its own, as the workers hand them over, then copied one
    file at a time into pinned group buffers, by each way of COPY_WAYS, on
    an idle host and beside EXTRACT_WINDOW extracting threads (_Load):
    the wall, the thread's CPU, and both again for the same bytes copied as
    one array a group (the per-file calls apart); every way's rows equal."""
    datas, copies = phase15_corpus()
    B = bench.CORPUS_B
    packed = [tlc.pack_lanes(pipeline.extract_traces(
        d, scope="gop", want_slots=False)[3], B)[:3] for d in datas]
    files = [tuple(a.copy() for a in packed[i % len(datas)])
             for i in range(len(datas) * copies)]
    index = {tlc.index_form(f[0]) for f in files}
    if index != {True}:
        raise RuntimeError("copy split: phase 15's rows are not all in the "
                           "index form")
    Bp = tlc.lane_bins(files[0][0])
    rows = sum(f[0].shape[0] for f in files)
    nbytes = sum(a.nbytes for f in files for a in f)
    group = tlc._Group(True, Bp, rows, pin=True)
    whole = tuple(np.concatenate([f[k] for f in files]) for k in range(3))

    def per_file(put):
        r0 = 0
        for f in files:
            put(group, r0, *f)
            r0 += f[0].shape[0]

    got = {}
    for load in (False, True):
        for name, put in COPY_WAYS.items():
            for unit, run in (("a file a call", lambda: per_file(put)),
                              ("one call", lambda: put(group, 0, *whole))):
                best = None
                for _ in range(RUNS):
                    group.np[0][:] = 0
                    with (_Load(datas) if load else _NoLoad()):
                        t0, c0 = time.perf_counter(), time.thread_time()
                        run()
                        t = (time.perf_counter() - t0, time.thread_time() - c0)
                    best = t if best is None or t[0] < best[0] else best
                    if not np.array_equal(group.np[0], whole[0]):
                        raise RuntimeError(f"copy split: {name} differs")
                got[(load, name, unit)] = best
    log(f"copy split: {len(files)} files, {rows} rows at B={B}, "
        f"{nbytes} bytes, into a pinned group; s wall [thread CPU], least "
        f"wall of {RUNS}, load = {pipeline.EXTRACT_WINDOW} extracting "
        f"threads ({os.cpu_count()} cores): " + "; ".join(
            f"{'loaded' if load else 'idle'} {name} {unit} {w:.4f} [{c:.4f}]"
            for (load, name, unit), (w, c) in got.items()))


class _NoLoad:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


ROUTE_FILES = ("bench_1080p_hq.mp4", "bench_4k.mp4", "mid.mp4")
ROUTE_BS = (4096, 16384)


def _add_traces_copied(self, traces, B):
    """LaneBatcher.add_traces with every file packed apart (pack_lanes) and
    copied in (add): the corpus driver's route, on the batcher's thread."""
    p1, bitw, lens, spans = tlc.pack_lanes(traces, B)
    return self.add(p1, bitw, lens), spans


def route_split(dev):
    """A single file's two routes into a dispatch group: add_traces (the
    native packer writes at the group's fill row) against pack_lanes into
    arrays of the file's own, then add (the copy): the stage alone (one
    file into a group that does not dispatch), and device_compress whole
    with LaneBatcher.add_traces swapped for the copied route, in turns,
    least of RUNS each; the containers equal."""
    real = tlc.LaneBatcher.add_traces
    for name in ROUTE_FILES:
        with open(os.path.join(ROOT, "data", name), "rb") as f:
            data = f.read()
        traces = pipeline.extract_traces(data, scope="gop",
                                         want_slots=False)[3]
        for B in ROUTE_BS:
            L = native.lane_rows(traces, B)
            st, outs = Stages(), {}
            for _ in range(RUNS):
                for way, fn in (("in place", real),
                                ("copied", _add_traces_copied)):
                    bat = tlc.LaneBatcher(dev, L + 1)
                    st.time(f"stage {way}", lambda: fn(bat, traces, B))
                    bat.close()
                    try:
                        tlc.LaneBatcher.add_traces = fn
                        outs[way] = st.time(
                            f"device_compress {way}",
                            lambda: pipeline.device_compress(
                                data, scope="gop", substream_bins=B,
                                device=dev))
                    finally:
                        tlc.LaneBatcher.add_traces = real
            if outs["in place"] != outs["copied"]:
                raise RuntimeError("route split: the containers differ")
            log(f"route split {name} B={B}: {len(data)} bytes, "
                f"{sum(map(len, traces))} bins, {L} rows, ms, least of "
                f"{RUNS}: {st.line()}")


def lane_transfer_parts(dev):
    """What the upload and the read-back of the full group are made of:
    p1 to the card from pageable memory, through a fresh pinned copy, the
    host copy and the bus apart, and through the staging ring; then the
    lengths, the strided copy into pinned memory, and tobytes()."""
    p1u16, bitw, lens = tiled_problem(CLIPS, FULL_L, FULL_B)
    src = torch.from_numpy(p1u16)
    mb = src.numel() * src.element_size() / 1e6
    pinned = torch.empty_like(src).pin_memory()
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    st = Stages()
    for _ in range(RUNS):
        st.time("pageable .to(device)", lambda: src.to(dev))
        st.time("fresh pin_memory() copy, then the bus",
                lambda: src.pin_memory().to(dev, non_blocking=True))
        st.time("host copy into pinned memory", lambda: pinned.copy_(src))
        st.time("the bus, from pinned memory",
                lambda: dst.copy_(pinned, non_blocking=True))
        st.time("staging ring (lane_coder._upload)",
                lambda: tlc._upload(p1u16, dev))
    log(f"lane upload of p1 ({mb:.0f} MB, {torch.get_num_threads()} host "
        f"threads), ms: {st.line()}; MB/ms: "
        + ", ".join(f"{mb / v:.1f}" for v in st.best.values()))
    del pinned, dst
    out, nbytes, total = tlc.lane_encode_streams(
        *tlc.from_numpy_problem(p1u16, bitw, lens, dev), tlc.max_bytes(FULL_B))
    st = Stages()
    for _ in range(RUNS):
        nb = st.time("lengths .cpu()", lambda: torch.stack(
            [nbytes, total]).cpu().numpy()[0])
        w = int(nb.max())
        host = torch.empty((FULL_L, w), dtype=torch.uint8).pin_memory()
        st.time("strided copy into pinned memory",
                lambda: host.copy_(out[:, :w], non_blocking=True))
        st.time("tobytes()", lambda: host.numpy().tobytes())
    log(f"lane read-back parts ({FULL_L} x {w} bytes, {int(nb.sum())} of "
        f"them stream bytes), ms: {st.line()}")


def decode_stages(dev, clip, B):
    with open(os.path.join(ROOT, "data", clip), "rb") as f:
        data = f.read()
    blob = (codec.compress(data, scope="gop", substream_bins=B) if B
            else native.compress(data, scope="gop"))
    st = Stages()
    for _ in range(RUNS):
        out, units, _ = decompress_stages(blob, dev, st.time)
        if out != data:
            raise RuntimeError("the staged decode differs from the file")
    whole = st.time("device_decompress",
                    lambda: pipeline.device_decompress(blob, device=dev))
    if whole != data:
        raise RuntimeError("device_decompress differs from the file")
    wall, busy = device_busy_ms(
        lambda: pipeline.device_decompress(blob, device=dev))
    counts = [len(m.rec_p1s) for m in units]
    log(f"decode stages {clip} gop B={B} ({len(units)} units, {sum(counts)} "
        f"bins, longest {max(counts)}), ms: {st.line()}; profiled call "
        f"{wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
        f"{1 - busy / wall:.1%}")


def main():
    parts = sys.argv[1:] or list(PARTS)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_stages.py needs an NVIDIA GPU")
    if set(parts) - set(PARTS):
        raise SystemExit(f"parts: {' '.join(PARTS)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"device: {torch.cuda.get_device_name(0)} ({card_line()})")
    warm_up(dev)
    for part in parts:
        PARTS[part](dev)


def warm_up(dev):
    """Builds, first launches, allocator."""
    with open(os.path.join(ROOT, "data", CLIPS[0]), "rb") as f:
        pipeline.device_compress(f.read(), scope="slice", substream_bins=0,
                                 device=dev)


def est_all(dev):
    for clip in ("rt_ctr.mkv", "mbaff_b.mkv"):
        for scope in ("slice", "gop"):
            est_stages(dev, clip, scope)


def est_unpack_stage(dev):
    group = archive_group()
    traces = list({id(t): t for t in group}.values())
    S, T = len(group), max(map(len, group))
    NS = max(len(t.limits) for t in group)
    n_bins = sum(map(len, group))
    st = Stages()
    for _ in range(RUNS):
        for t in traces:  # pack_rows caches each trace's fields
            t._slots = t._bits = t._pcabs = None
        rows = st.time("pack_rows", lambda: tec.pack_rows(group, S, T, NS))
        packed = st.time("pack_rows upload",
                         lambda: tec.from_numpy_traces(*rows, dev))
        del rows
        views = [tec.trace_records(t) for t in group]
        tables = st.time("slot_tables", lambda: tec.slot_tables(group, S, NS))
        recs = st.time("records upload",
                       lambda: [tec._upload(v, dev) for v in views])
        st.time("est_unpack", lambda: tec.est_unpack(recs, S, T))
        unpacked = st.time("_records_problem", lambda: tec._records_problem(
            views, tables, S, T, dev))
        if not all(torch.equal(a, b) for a, b in zip(packed, unpacked)):
            raise RuntimeError("est_unpack's rows differ from pack_rows'")
        del packed, unpacked
    got = tec.est_unpack(recs, S, T)
    table = tec.record_table(recs)
    kernel = cuda_ms(lambda: tec._unpack_launch(table, S, got), 10)
    want = []
    plain = cuda_ms(lambda: want.append(tec.est_unpack_plain(recs, S, T)), 1)
    if not all(torch.equal(a, b) for a, b in zip(got, want[0])):
        raise RuntimeError("est_unpack differs from est_unpack_plain")
    # each valid bin's record read once, the four rows written once, the
    # pointer table; three masks and shifts a padded bin
    n_bytes = 8 * n_bins + 16 * S * T + 16 * S
    bound, by = bound_ms(n_bytes, 3 * S * T)
    log(f"est unpack [{S}, {T}] ({n_bins} bins, NS={NS}) on {card_line()}, "
        f"ms: {st.line()}; est_unpack by CUDA events {kernel:.3f} ms, bound "
        f"{bound:.3f} ms by {by} ({n_bytes} bytes), at {bound / kernel:.1%} "
        f"of it; plain on the card {plain:.1f} ms; rows equal to "
        f"pack_rows' and the plain version's")


def archive_split(dev):
    gops = []
    for i in range(1, 5):
        path = os.path.join(ROOT, "benchmark", "clips", "camera",
                            f"cam_gop{i}.264")
        with open(path, "rb") as f:
            gops.append(f.read())
    for n_gops in ARCHIVE_GOPS:
        archive_recording(dev, b"".join(gops[i % len(gops)]
                                        for i in range(n_gops)), n_gops)
    # the longest recording's one launch alone, with its stage waits: the
    # stage that sets the pace
    phase_est_archive(dev, card_line(), archive_group())


def archive_recording(dev, data, n_gops):
    want = pipeline.device_compress(data, scope="gop", substream_bins=0,
                                    device=dev)
    for _ in range(ARCHIVE_RUNS):
        stats = {}
        torch.cuda.reset_peak_memory_stats(dev)
        with PeakRSS() as rss:
            t0 = time.perf_counter()
            out = pipeline.device_compress(data, scope="gop",
                                           substream_bins=0, device=dev,
                                           stats=stats)
            wall = time.perf_counter() - t0
        if out != want:
            raise RuntimeError("the archive recording's containers differ")
        split = ", ".join(f"{k} {stats[k]:.3f}" if isinstance(stats[k], float)
                          else f"{k} {stats[k]}" for k in EST_KEYS
                          if k in stats)
        if stats.get("est_launches"):
            split += (", est_traces / est_launches "
                      f"{stats['est_traces'] / stats['est_launches']:.1f}")
        log(f"archive recording ({n_gops} GOPs, {len(data)} bytes -> "
            f"{len(out)}) on {card_line()}: {wall:.3f} s wall; {split}; peak "
            f"RSS {rss.peak / 1e6:.0f} MB ({rss.before / 1e6:.0f} before), "
            f"device peak {torch.cuda.max_memory_allocated(dev)} B")


def decode_all(dev):
    for clip in ("rt_ctr.mkv", "mbaff_b.mkv"):
        for B in (4096, 0):
            decode_stages(dev, clip, B)


PARTS = {"est": est_all, "pack": lane_pack_stage, "group": group_stages,
         "lane": lane_stages, "corpus": corpus_split, "window": corpus_window,
         "benchcorpus": bench_corpus, "bigcorpus": big_corpus,
         "copy": copy_split, "route": route_split,
         "transfer": lane_transfer_parts,
         "decode": decode_all, "unpack": est_unpack_stage,
         "archive": archive_split}


if __name__ == "__main__":
    main()
