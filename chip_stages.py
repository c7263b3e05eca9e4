#!/usr/bin/env python3
"""Where the time goes in the port's two device paths, stage by stage, on
one GPU.

    python3 chip_stages.py        # from the repository root, one CUDA card

Each stage is timed on the host clock with a synchronize after it, the
least of three runs; the whole call is timed the same way, and once more
under torch.profiler for the device's busy time (the sum over kernels,
copies and fills; idle share = 1 - busy / wall, an underestimate where a
copy overlaps a kernel).  Not a benchmark: no spread, small pinned clips.

  est path   device_compress(data, scope, substream_bins=0) on rt_ctr.mkv
             and mbaff_b.mkv at slice and gop scope: extract, pack, upload,
             range check, zero fill, kernel, read-back, finalize, container
  lane path  lane_streams_device_compact on one full dispatch group
             [8192, 16384] tiled from the clips' real traces: upload,
             kernel, finalize, collect
"""

import os
import time

import torch

from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline
from avrecode_tpu_torch.utils.container import SCOPE_GOP, SCOPE_SLICE
from chip_smoke import CLIPS, FULL_B, FULL_L, ROOT, card_line, log, tiled_problem

RUNS = 3


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
    M = tlc.max_bytes(FULL_B)
    st = Stages()
    for _ in range(RUNS):
        prob = st.time("upload", lambda: tuple(
            tlc._upload(a, dev) for a in (p1u16, bitw, lens)))
        raw = st.time("kernel", lambda: tlc.lane_encode(*prob))
        fin = st.time("finalize", lambda: tlc.finalize_device(*raw, M))
        parts = st.time("collect", lambda: tlc.lane_collect(
            [(FULL_L, lens, (*fin, raw))]))
        del raw, fin
        whole = st.time("lane_streams_device_compact", lambda:
                        tlc.lane_streams_device_compact(p1u16, bitw, lens, dev))
        if parts != whole:
            raise RuntimeError("the staged run and the whole call differ")
    wall, busy = device_busy_ms(
        lambda: tlc.lane_streams_device_compact(p1u16, bitw, lens, dev))
    log(f"lane stages [{FULL_L}, {FULL_B}], ms: {st.line()}; profiled call "
        f"{wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
        f"{1 - busy / wall:.1%}")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_stages.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"device: {torch.cuda.get_device_name(0)} ({card_line()})")
    # warm-up: builds, first launches, allocator
    with open(os.path.join(ROOT, "data", CLIPS[0]), "rb") as f:
        pipeline.device_compress(f.read(), scope="slice", substream_bins=0,
                                 device=dev)
    for clip in ("rt_ctr.mkv", "mbaff_b.mkv"):
        for scope in ("slice", "gop"):
            est_stages(dev, clip, scope)
    lane_stages(dev)


if __name__ == "__main__":
    main()
