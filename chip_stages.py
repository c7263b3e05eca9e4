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
             passes each, each pass's host time by stage (CORPUS_SPLIT, the
             stages the tree has): the main thread's wait on the
             extractions, packing into staging, upload, launch, read-back,
             the rest of collect, envelopes, serialisation, the rest of the
             wall; the extraction summed over the worker threads beside
             them; the pass's peak RSS (VmRSS sampled on a thread) and its
             peak device memory (torch.cuda.max_memory_allocated above what
             was allocated before it)
  window     the same corpus at B = 16384, at each extraction window of
             WINDOWS and each extraction's GOP threads of GOP_THREADS, two
             passes each, split as above
  transfer   the ways to bring the group's p1 (268 MB) to the card, and the
             parts of the read-back
  decode     device_decompress(blob) on containers of rt_ctr.mkv and
             mbaff_b.mkv at gop scope, v2 (B = 4096) and v1: host model
             pass, pack, upload, kernel, read-back, split, host assembly
"""

import concurrent.futures
import os
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
    BENCH_GROUPS, BENCH_SET, CLIPS, FULL_B, FULL_L, ROOT, PeakRSS, card_line,
    decompress_stages, group_ring_bytes, lane_stage_split, log, tiled_problem,
    tiled_trace)

RUNS = 3
CORPUS_BS = (16384, 4096)  # the corpus split's B: the bench's, and ~8 groups
WINDOWS = (1, 2, 4, 8, 16)  # extraction windows of the `window` part
GOP_THREADS = (0, 1)  # an extraction's GOP threads in the `window` part
WINDOW_RUNS = 2


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


# (owner, attribute, stage) of a corpus pass's stages
CORPUS_SPLIT = (
    (tlc.LaneBatcher, "add_traces", "pack into staging (add_traces)"),
    (tlc, "upload_group", "upload (copy_)"),
    (tlc, "dispatch_group", "launch"),
    (tlc, "read_group", "read-back"),
    (tlc, "collect_groups", "the rest of collect"),
    (tlc.GroupStreams, "envelope", "envelopes"),
    (pipeline, "_serialize", "serialisation"),
)


class Split:
    """Host time by stage: each wrapped call's time less the time of the
    wrapped calls inside it (a stack a thread); a stage that runs on
    several threads at once is summed over them."""

    def __init__(self):
        self.spent = {}
        self.local = threading.local()
        self.lock = threading.Lock()

    def wrap(self, fn, name):
        def run(*args, **kwargs):
            stack = self.local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                with self.lock:
                    self.spent[name] = self.spent.get(name, 0.0) + dt - inner
                if stack:
                    stack[-1] += dt
        return run


class TimedFuture:
    """A future whose result() the Split times; it holds the future, and
    not the other way round, so that a future let go (with the traces in
    its result) is freed at once, as the pipeline's own are."""

    def __init__(self, fut, split):
        self.fut = fut
        self.result = split.wrap(fut.result, "extraction wait")

    def cancel(self):
        return self.fut.cancel()


def split_pass(corpus, B, dev, window=None, threads=None):
    """One device_compress_corpus pass with every stage of CORPUS_SPLIT
    that the tree has wrapped in a Split, the extraction on the worker
    threads (summed over them) and the main thread's wait for it too:
    (containers, stats, {stage: s}) with the wall time, the rest (the wall
    less the main thread's stages), the pass's peak RSS and its device
    peak (bytes above what was allocated before it).  window sets
    pipeline.EXTRACT_WINDOW, threads each extraction's GOP threads (0 =
    the extractor's own count), for the pass."""
    split = Split()
    extract = pipeline.extract_traces
    if threads is not None:
        def extract(data, real=extract, **kw):
            return real(data, **dict(kw, threads=threads))
    saved = [(pipeline, "extract_traces", extract,
              "extraction (worker threads)")]
    saved += [(owner, attr, getattr(owner, attr), name)
              for owner, attr, name in CORPUS_SPLIT if hasattr(owner, attr)]
    originals = [(pipeline, "extract_traces", pipeline.extract_traces)] + [
        (owner, attr, fn) for owner, attr, fn, _ in saved[1:]]
    if window is not None:
        originals.append((pipeline, "EXTRACT_WINDOW", pipeline.EXTRACT_WINDOW))
    pool = concurrent.futures.ThreadPoolExecutor

    class TimedPool(pool):
        def submit(self, fn, *args, **kwargs):
            return TimedFuture(super().submit(fn, *args, **kwargs), split)

    stats = {}
    try:
        for owner, attr, fn, name in saved:
            setattr(owner, attr, split.wrap(fn, name))
        if window is not None:
            pipeline.EXTRACT_WINDOW = window
        concurrent.futures.ThreadPoolExecutor = TimedPool
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        allocated = torch.cuda.memory_allocated(dev)
        with PeakRSS() as rss:
            t0 = time.perf_counter()
            outs = pipeline.device_compress_corpus(
                corpus, scope="gop", substream_bins=B, device=dev,
                stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_peak = torch.cuda.max_memory_allocated(dev) - allocated
    finally:
        concurrent.futures.ThreadPoolExecutor = pool
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
    spent = dict(split.spent)
    worker = spent.pop("extraction (worker threads)", 0.0)
    spent["the rest"] = wall - sum(spent.values())
    spent["wall"] = wall
    spent["extraction (worker threads)"] = worker
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


def corpus_window(dev):
    """device_compress_corpus on phase 15's corpus at the bench's B, at
    each extraction window of WINDOWS and each extraction's GOP threads of
    GOP_THREADS (0: the extractor's own count, up to 16), WINDOW_RUNS
    passes each (split_pass)."""
    datas, copies = phase15_corpus()
    corpus = datas * copies
    for threads in GOP_THREADS:
        for window in WINDOWS:
            stats, passes = corpus_passes(corpus, bench.CORPUS_B, dev,
                                          WINDOW_RUNS, window=window,
                                          threads=threads)
            log(f"corpus window={window} threads={threads} "
                f"B={bench.CORPUS_B} ({os.cpu_count()} cores): "
                f"{stats['dispatches']} dispatches; s a pass, median of "
                f"{WINDOW_RUNS} (each pass): {median_line(passes)}")


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
    # warm-up: builds, first launches, allocator
    with open(os.path.join(ROOT, "data", CLIPS[0]), "rb") as f:
        pipeline.device_compress(f.read(), scope="slice", substream_bins=0,
                                 device=dev)
    for part in parts:
        PARTS[part](dev)


def est_all(dev):
    for clip in ("rt_ctr.mkv", "mbaff_b.mkv"):
        for scope in ("slice", "gop"):
            est_stages(dev, clip, scope)


def decode_all(dev):
    for clip in ("rt_ctr.mkv", "mbaff_b.mkv"):
        for B in (4096, 0):
            decode_stages(dev, clip, B)


PARTS = {"est": est_all, "pack": lane_pack_stage, "group": group_stages,
         "lane": lane_stages, "corpus": corpus_split, "window": corpus_window,
         "transfer": lane_transfer_parts, "decode": decode_all}


if __name__ == "__main__":
    main()
