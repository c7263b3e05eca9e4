#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (avrecode_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure raises and the script exits non-zero:
  1 device   a CUDA card must be present; prints nvidia-smi's name and
             power limit
  2 build    libavtpu.so (make, g++ only) when missing, and the CUDA
             kernels from avrecode_tpu_torch/csrc (nvcc, sm_90a)
  3 kernel   lane_encode (CUDA kernel) vs lane_encode_plain on the same
             card tensors, exact, over random lanes with ragged lens at
             (L, B) in (1, 256), (1000, 4096), (8192, 16384), a carry-stress
             case, and the overflow-finalize path
  4 main     device_compress on the pinned clips at gop scope and
             B in (4096, 16384): byte-identical to codec.compress and
             roundtripping through both decoders; device_compress_corpus
             equal to the per-file results; the kernel must have launched
  5 full     one full dispatch group, [8192, 16384] lanes tiled from the
             clips' real (bit, p1) traces, kernel vs plain: equal streams,
             and both timed with CUDA events
  6 kernel   est_encode (CUDA kernel) vs est_encode_plain on the same card
             tensors, exact: random traces over all key classes, the
             skewed carry stress, invalid bins inside traces, 4,096 slots
  7 main     device_compress(substream_bins=0) on the pinned clips at
             slice and gop scope: byte-identical to native.compress (and
             to codec.compress for one clip), roundtripping through both
             decoders; the est kernel must have launched
  8 full     the clips' slice traces replicated to 1,024 traces in one
             encode_traces_est call; kernel vs plain on that problem:
             equal tokens, both timed with CUDA events; and the kernel
             alone on the longest gop trace
The last three lines are a JSON line of kernel numbers, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from avrecode_tpu import codec
from avrecode_tpu.host import native
from avrecode_tpu_torch.ops import _build
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel.pipeline import (
    device_compress, device_compress_corpus)

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "rt_ctr.ts", "rt_ctr.avi",
         "rt_ctr.flv", "rt_ctr.mpg"]
FULL_L, FULL_B = 8192, 16384  # one full dispatch group at the bench's B
EST_S = 1024  # traces of the phase-8 est problem


def log(*args):
    print(*args, flush=True)


def card_line():
    """nvidia-smi's "name, power.limit" for card 0."""
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def lanes(kind, L, B, seed):
    """Compact lane problem (uint16 p1, int32 bit words, int32 lens) from a
    seed.  lens are ragged: B, 0, 1, B-1, then random in [0, B].  "carry":
    p1 near 0xFFFF with 30% of bins coded against it (pending carries and
    0xFF byte runs)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        p1 = rng.integers(1, 1 << 16, (L, B), dtype=np.int32)
        bits = rng.random((L, B), dtype=np.float32) * 65536 < p1
    else:
        p1 = rng.integers(0xFFF0, 1 << 16, (L, B), dtype=np.int32)
        bits = rng.random((L, B), dtype=np.float32) > 0.3
    lens = rng.integers(0, B + 1, L).astype(np.int32)
    special = [B, 0, 1, B - 1][:L]
    lens[: len(special)] = special
    bitw = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    return p1.astype(np.uint16), bitw, lens


def max_abs_diff(xs, ys):
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(xs, ys))


def phase_kernel_vs_plain(dev, cases):
    """lane_encode vs lane_encode_plain on the same tensors; returns the
    largest absolute difference seen (must be 0)."""
    worst = 0
    for kind, L, B in cases:
        prob = tlc.from_numpy_problem(*lanes(kind, L, B, seed=L + B), dev)
        t0 = time.time()
        got = tlc.lane_encode(*prob)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_k = time.time() - t0
        t0 = time.time()
        ref = tlc.lane_encode_plain(*prob)
        t_p = time.time() - t0
        err = max_abs_diff(got, ref)
        worst = max(worst, err)
        tok, car = ref[0], ref[1]
        n = (tok >> 16) & 3
        log(f"kernel vs plain {kind} L={L} B={B}: max_abs_err={err} "
            f"carries={int((car > 0).sum())} ff_bytes="
            f"{int((((tok & 0xFF) == 0xFF) & (n >= 1)).sum())} "
            f"(first call {t_k:.3f} s, plain {t_p:.1f} s)")
        if err or not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"kernel != plain for {kind} L={L} B={B}")
    return worst


def phase_overflow(dev, L, B):
    """Dense streams past the read-back bound take the exact host finalize
    of the kernel's tokens."""
    p1u16, bitw, lens = lanes("random", L, B, seed=7)
    before = tlc.lane_collect.overflows
    got = tlc.lane_streams_device_compact(p1u16, bitw, lens, dev,
                                          bits_per_byte=1000)
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, dev)
    ref = tlc.finalize_lanes(*(t.cpu().numpy()
                               for t in tlc.lane_encode_plain(*prob)), lens)
    log(f"overflow finalize: lane_collect.overflows="
        f"{tlc.lane_collect.overflows} (was {before})")
    if tlc.lane_collect.overflows <= before or got != ref:
        raise AssertionError("overflow-finalize path did not match")


def phase_main_path(dev, Bs, clips):
    """The port's main path on real clips, held to the host codec."""
    datas = [open(os.path.join(ROOT, "data", c), "rb").read() for c in clips]
    timings = []
    for B in Bs:
        per_file = []
        for clip, data in zip(clips, datas):
            t0 = time.time()
            out = device_compress(data, scope="gop", substream_bins=B,
                                  device=dev)
            dt = time.time() - t0
            if out != codec.compress(data, scope="gop", substream_bins=B):
                raise AssertionError(f"{clip} B={B}: port != codec.compress")
            if codec.decompress(out) != data:
                raise AssertionError(f"{clip} B={B}: codec.decompress differs")
            if native.decompress(out, 0) != data:
                raise AssertionError(f"{clip} B={B}: native.decompress differs")
            log(f"main path {clip} B={B}: {len(data)} -> {len(out)} bytes, "
                f"byte-identical, roundtrips both decoders "
                f"(device_compress {dt * 1e3:.1f} ms)")
            per_file.append(out)
        stats = {}
        t0 = time.time()
        outs = device_compress_corpus(datas, scope="gop", substream_bins=B,
                                      device=dev, stats=stats)
        dt = time.time() - t0
        if outs != per_file:
            raise AssertionError(f"B={B}: corpus != per-file containers")
        timings.append((B, dt, stats))
        log(f"corpus B={B}: {len(outs)} containers equal per-file, "
            f"{stats['bins']} bins, {stats['dispatches']} dispatches, "
            f"{dt:.3f} s = {len(outs) / dt:.2f} containers/s, "
            f"{stats['bins'] / dt:.4g} bins/s (host clock)")
    return timings


def tiled_problem(clips, L, B):
    """[L, B] lanes tiled from the real (bit, p1) traces of the clips."""
    p1s, bits = [], []
    for c in clips:
        data = open(os.path.join(ROOT, "data", c), "rb").read()
        for t in native.extract(data, "gop", want_slots=False)[3]:
            r32 = t.recs32()
            p1s.append((r32[:, 1] >> 16).astype(np.uint16))
            bits.append(((r32[:, 0] >> 24) & 1).astype(np.uint8))
    p1, bit = np.concatenate(p1s), np.concatenate(bits)
    reps = -(-(L * B) // len(p1))
    p1u16 = np.tile(p1, reps)[: L * B].reshape(L, B)
    bitw = np.packbits(np.tile(bit, reps)[: L * B].reshape(L, B), axis=1,
                       bitorder="little").view(np.int32)
    return p1u16, bitw, np.full(L, B, np.int32)


def cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_full_dispatch(dev, clips, L, B, card):
    p1u16, bitw, lens = tiled_problem(clips, L, B)
    t0 = time.time()
    streams = tlc.lane_streams_device_compact(p1u16, bitw, lens, dev)
    e2e = time.time() - t0
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, dev)
    raw = tlc.lane_encode_plain(*prob)
    M = tlc.max_bytes(B)
    plain_streams = tlc.lane_collect(
        [(L, lens, (*tlc.finalize_device(*raw, M), raw))])
    if streams != plain_streams:
        raise AssertionError("full dispatch: kernel streams != plain streams")
    del raw
    nbytes = sum(map(len, streams))
    log(f"full dispatch [{L}, {B}]: kernel and plain streams equal, "
        f"{L * B} bins -> {nbytes} bytes; lane_streams_device_compact "
        f"{e2e:.3f} s host clock = {L * B / e2e:.4g} bins/s end to end")
    if dev.type != "cuda":
        return None
    tlc.lane_encode(*prob)  # warm-up
    k1 = cuda_ms(lambda: tlc.lane_encode(*prob), 5)
    plain = cuda_ms(lambda: tlc.lane_encode_plain(*prob), 1)
    k2 = cuda_ms(lambda: tlc.lane_encode(*prob), 5)
    ms = (k1 + k2) / 2
    log(f"full dispatch timing [{L}, {B}] on {card}: kernel {k1:.3f} / "
        f"{k2:.3f} ms (mean {ms:.3f} ms), plain {plain:.1f} ms, kernel "
        f"{L * B / (ms / 1e3):.4g} bins/s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return ms, plain


def est_problem(kind, S, T, NS, seed):
    """Est problem (numpy int32 slots, bits, pcabs, limits, valid, cls)
    from a seed.  "random": cls over all key classes, random halving
    limits; "skew": tests/test_pallas.py's carry stress (98% ones, one
    class, limit 0x60); "holes": invalid bins inside every trace.  Row 0
    has a ragged tail, and every third pcab is 0 (no CABAC input)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, NS, (S, T))
    if kind == "skew":
        bits = rng.random((S, T), dtype=np.float32) < 0.98
        limits = np.full((S, NS), 0x60)
        cls = np.zeros((S, NS))
    else:
        bits = rng.integers(0, 2, (S, T))
        limits = rng.integers(0x10, 0x100, (S, NS))
        cls = rng.integers(0, tec.N_CLS, (S, NS))
    pcabs = rng.integers(0, 1 << 16, (S, T))
    pcabs[:, ::3] = 0
    valid = np.ones((S, T))
    valid[0, T - T // 3:] = 0
    if kind == "holes":
        valid[:, T // 4: T // 4 + 100] = 0
        valid[1::2, ::5] = 0
    return slots, bits, pcabs, limits, valid, cls


def token_stats(tok, car, count):
    """(carries, 0xFF bytes) among the emitted tokens."""
    live = (torch.arange(tok.shape[1], device=tok.device)[None, :]
            < count[:, None])
    return int(((car > 0) & live).sum()), int(((tok == 0xFF) & live).sum())


def phase_est_kernel_vs_plain(dev, cases):
    """est_encode vs est_encode_plain on the same tensors; returns the
    largest absolute difference seen (must be 0)."""
    worst = 0
    for kind, S, T, NS in cases:
        prob = tec.from_numpy_traces(*est_problem(kind, S, T, NS, S + T + NS),
                                     dev)
        t0 = time.time()
        got = tec.est_encode(*prob)
        torch.cuda.synchronize(dev)
        t_k = time.time() - t0
        t0 = time.time()
        ref = tec.est_encode_plain(*prob)
        torch.cuda.synchronize(dev)
        t_p = time.time() - t0
        err = max_abs_diff(got, ref)
        worst = max(worst, err)
        carries, ffs = token_stats(*ref)
        log(f"est kernel vs plain {kind} S={S} T={T} NS={NS}: "
            f"max_abs_err={err} carries={carries} ff_bytes={ffs} "
            f"(first call {t_k:.3f} s, plain {t_p:.1f} s)")
        if err or not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"est kernel != plain for {kind} S={S} T={T}")
    return worst


def phase_est_main_path(dev, clips):
    """device_compress(substream_bins=0) on real clips, held to the host."""
    for k, clip in enumerate(clips):
        data = open(os.path.join(ROOT, "data", clip), "rb").read()
        for scope in ("slice", "gop"):
            t0 = time.time()
            out = device_compress(data, scope=scope, substream_bins=0,
                                  device=dev)
            dt = time.time() - t0
            if out != native.compress(data, scope=scope):
                raise AssertionError(f"{clip} {scope}: port != native.compress")
            if k == 0 and out != codec.compress(data, scope=scope):
                raise AssertionError(f"{clip} {scope}: port != codec.compress")
            if codec.decompress(out) != data:
                raise AssertionError(f"{clip} {scope}: codec.decompress differs")
            if native.decompress(out, 0) != data:
                raise AssertionError(f"{clip} {scope}: native.decompress differs")
            log(f"est main path {clip} {scope}: {len(data)} -> {len(out)} "
                f"bytes, byte-identical, roundtrips both decoders "
                f"(device_compress {dt * 1e3:.1f} ms)")


def phase_est_full(dev, clips, S, card):
    """The clips' slice traces, whole, replicated to S traces: one
    encode_traces_est call, then kernel vs plain on the packed problem."""
    traces = []
    for c in clips:
        data = open(os.path.join(ROOT, "data", c), "rb").read()
        traces += native.extract(data, "slice", want_slots=True)[3]
    traces = (traces * -(-S // len(traces)))[:S]
    n_bins = sum(map(len, traces))
    T = max(map(len, traces))
    NS = max(len(t.limits) for t in traces)
    t0 = time.time()
    streams = tec.encode_traces_est(traces, dev)
    e2e = time.time() - t0
    prob = tec.from_numpy_traces(*tec.pack_rows(traces, S, T, NS), dev)
    got = tec.est_encode(*prob)
    k1 = cuda_ms(lambda: tec.est_encode(*prob), 3)
    ref = []
    plain = cuda_ms(lambda: ref.append(tec.est_encode_plain(*prob)), 1)
    k2 = cuda_ms(lambda: tec.est_encode(*prob), 3)
    err = max_abs_diff(got, ref[0])
    if err or not all(torch.equal(a, b) for a, b in zip(got, ref[0])):
        raise AssertionError("est full size: kernel tokens != plain tokens")
    if streams != tec.finalize_streams(*(t.cpu() for t in ref[0])):
        raise AssertionError("est full size: encode_traces_est streams differ")
    ms = (k1 + k2) / 2
    log(f"est full size [{S}, {T}] NS={NS}: kernel and plain tokens equal, "
        f"{n_bins} bins -> {sum(map(len, streams))} bytes; "
        f"encode_traces_est {e2e:.3f} s host clock = {n_bins / e2e:.4g} "
        f"bins/s end to end")
    log(f"est full size timing [{S}, {T}] on {card}: kernel {k1:.3f} / "
        f"{k2:.3f} ms (mean {ms:.3f} ms, {n_bins / (ms / 1e3):.4g} bins/s), "
        f"plain {plain:.1f} ms ({n_bins / (plain / 1e3):.4g} bins/s)")
    del got, ref, prob

    data = open(os.path.join(ROOT, "data", "mbaff_b.mkv"), "rb").read()
    longest = max(native.extract(data, "gop", want_slots=True)[3], key=len)
    prob = tec.from_numpy_traces(
        *tec.pack_rows([longest], 1, len(longest), len(longest.limits)), dev)
    tec.est_encode(*prob)  # warm-up
    one = cuda_ms(lambda: tec.est_encode(*prob), 3)
    log(f"est longest gop trace (mbaff_b.mkv, {len(longest)} bins, one "
        f"thread) on {card}: kernel {one:.3f} ms = "
        f"{one * 1e3 / len(longest):.3f} us/bin")
    return err, ms, plain


def main():
    # 1 device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    # 2 build
    if not os.path.exists(os.path.join(ROOT, "avrecode_tpu", "host",
                                       "libavtpu.so")):
        t0 = time.time()
        subprocess.run(["make", "-C", os.path.join(ROOT, "avrecode_tpu", "host"),
                        "libavtpu.so"], check=True, capture_output=True)
        log(f"build: libavtpu.so {time.time() - t0:.1f} s")
    if not native.available():
        raise RuntimeError("libavtpu.so did not load")
    t0 = time.time()
    _build.load()
    log(f"build: lane_encode and est_encode kernels {time.time() - t0:.1f} s "
        f"({_build.library_path().name})")
    log(_build.build_log().strip())

    # 3 kernel vs plain on the card
    err = phase_kernel_vs_plain(dev, [
        ("random", 1, 256), ("random", 1000, 4096), ("carry", 1000, 4096),
        ("random", FULL_L, FULL_B)])
    phase_overflow(dev, 1000, 4096)

    # 4 main path; the launch count covers exactly this phase
    tlc.lane_encode.launches = 0
    phase_main_path(dev, (4096, 16384), CLIPS)
    launches = tlc.lane_encode.launches
    log(f"main path: lane_encode.launches={launches}")
    if launches <= 0:
        raise AssertionError("main path never launched the lane_encode kernel")

    # 5 full-size dispatch
    ms, plain_ms = phase_full_dispatch(dev, CLIPS, FULL_L, FULL_B, card)

    # 6 est kernel vs plain on the card
    est_err = phase_est_kernel_vs_plain(dev, [
        ("random", 64, 4096, 1024), ("skew", 64, 2048, 64),
        ("holes", 64, 2048, 512), ("random", 16, 2048, 4096)])

    # 7 est main path; the launch count covers exactly this phase
    tec.est_encode.launches = 0
    phase_est_main_path(dev, CLIPS)
    est_launches = tec.est_encode.launches
    log(f"est main path: est_encode.launches={est_launches}")
    if est_launches <= 0:
        raise AssertionError("est main path never launched the est_encode kernel")

    # 8 est full size
    full_err, est_ms, est_plain_ms = phase_est_full(dev, CLIPS, EST_S, card)

    print(json.dumps({"kernels": [{
        "name": "lane_encode",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/lane_encode.cu",
        "replaces": "avrecode_tpu/ops/lane_coder.py:195",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "est_encode",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/est_encode.cu",
        "replaces": "avrecode_tpu/ops/pallas_coder.py:48",
        "launches": est_launches,
        "max_abs_err": max(est_err, full_err),
        "ms": est_ms,
        "plain_ms": est_plain_ms,
    }]}))
    print(card)
    # the smoke drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
