#!/usr/bin/env python3
"""Where the time goes in the port's device paths, stage by stage, on one
GPU.

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
             kernel (lane_encode_streams), read-back, slicing; then the
             ways to bring the group's p1 (268 MB) to the card, and the
             parts of the read-back
  decode     device_decompress(blob) on containers of rt_ctr.mkv and
             mbaff_b.mkv at gop scope, v2 (B = 4096) and v1: host model
             pass, pack, upload, kernel, read-back, split, host assembly
"""

import os
import time

import torch

from avrecode_tpu_torch import codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel import pipeline
from avrecode_tpu_torch.utils.container import SCOPE_GOP, SCOPE_SLICE
from chip_smoke import (
    CLIPS, FULL_B, FULL_L, ROOT, card_line, decompress_stages,
    lane_stage_split, log, tiled_problem)

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
    tlc.lane_streams_device_compact(p1u16, bitw, lens, dev)  # pinned buffers
    best, parts = lane_stage_split(dev, p1u16, bitw, lens, RUNS)
    st = Stages()
    st.best = best
    for _ in range(RUNS):
        whole = st.time("lane_streams_device_compact", lambda:
                        tlc.lane_streams_device_compact(p1u16, bitw, lens, dev))
        if parts != whole:
            raise RuntimeError("the staged run and the whole call differ")
    wall, busy = device_busy_ms(
        lambda: tlc.lane_streams_device_compact(p1u16, bitw, lens, dev))
    log(f"lane stages [{FULL_L}, {FULL_B}], ms: {st.line()}; profiled call "
        f"{wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
        f"{1 - busy / wall:.1%}")


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
    lane_transfer_parts(dev)
    for clip in ("rt_ctr.mkv", "mbaff_b.mkv"):
        for B in (4096, 0):
            decode_stages(dev, clip, B)


if __name__ == "__main__":
    main()
