#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (avrecode_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure raises and the script exits non-zero:
  1 device   a CUDA card must be present; prints nvidia-smi's name and
             power limit
  2 build    the port's libavtpu.so from avrecode_tpu_torch/host/src (make,
             g++ only) and the CUDA kernels from avrecode_tpu_torch/csrc
             (nvcc, sm_90a), each at first use into build/
  3 kernel   lane_encode (CUDA kernel) vs lane_encode_plain on the same
             card tensors, exact, over random lanes with ragged lens (0, 1,
             a tile of 128 bins less one, a tile, a tile and one, ...):
             lane counts that are no multiple of a warp's 16, widths that are no
             multiple of the tile, a carry-stress case, and the
             overflow-finalize path
  4 main     device_compress on the pinned clips at gop scope and
             B in (4096, 16384): byte-identical to codec.compress and
             roundtripping through both decoders; device_compress_corpus
             equal to the per-file results; the kernel must have launched
  5 full     one full dispatch group, [8192, 16384] lanes tiled from the
             clips' real (bit, p1) traces, kernel vs plain: equal tokens
             and streams, both timed with CUDA events, the kernel's time
             beside its bound from the byte count
  6 kernel   est_encode (CUDA kernel) vs est_encode_plain on the same card
             tensors, exact: random traces over all key classes, the
             skewed carry stress, invalid bins inside traces, 4,096 slots,
             slot counts on both sides of the shared-memory budget, trace
             lengths under and off the 32-bin tile, valid bins only in one
             tile's tail, one slot hit by every bin, and counters driven
             to every halving limit up to 0x7FFF
  7 main     device_compress(substream_bins=0) on the pinned clips at
             slice and gop scope: byte-identical to native.compress (and
             to codec.compress for one clip), roundtripping through both
             decoders; the est kernel must have launched
  8 full     the clips' slice traces replicated to 1,024 traces in one
             encode_traces_est call; kernel vs plain on that problem:
             equal tokens, both timed with CUDA events, the kernel's time
             beside its bound; the kernel alone on the longest gop trace
             and on the longest slice trace replicated 1 to 4,096 times
The last three lines are a JSON line of kernel numbers, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from avrecode_tpu_torch import codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import _build
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel.pipeline import (
    device_compress, device_compress_corpus, extract_traces)

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "rt_ctr.ts", "rt_ctr.avi",
         "rt_ctr.flv", "rt_ctr.mpg"]
FULL_L, FULL_B = 8192, 16384  # one full dispatch group at the bench's B
EST_S = 1024  # traces of the phase-8 est problem
EST_SCALING = (1, 32, 128, 1024, 4096)  # copies of one trace, kernel alone
# the card's peaks for the bounds (NVIDIA H100 SXM data sheet): memory
# rate, and integer operations at half the 67 TFLOP/s float32 rate (an SM
# has half as many int32 lanes as float32 lanes)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
LANE_OPS_PER_BIN = 30  # integer operations of one lane_encode bin
EST_OPS_PER_BIN = 150  # and of one est_encode bin


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
    seed.  lens are ragged: B, 0, 1, B-1, the kernel's tile and 8-bin group
    edges, then random in [0, B].  "zero": random, with p1 = 0 on 1% of the
    bins (no model gives it; the coder's range collapses to 0).  "carry":
    p1 near 0xFFFF with 30% of bins coded against it (pending carries and
    0xFF byte runs)."""
    rng = np.random.default_rng(seed)
    if kind in ("random", "zero"):
        p1 = rng.integers(1, 1 << 16, (L, B), dtype=np.int32)
        bits = rng.random((L, B), dtype=np.float32) * 65536 < p1
        if kind == "zero":
            p1[rng.random((L, B), dtype=np.float32) < 0.01] = 0
    else:
        p1 = rng.integers(0xFFF0, 1 << 16, (L, B), dtype=np.int32)
        bits = rng.random((L, B), dtype=np.float32) > 0.3
    lens = rng.integers(0, B + 1, L).astype(np.int32)
    special = [n for n in (B, 0, 1, B - 1, 127, 128, 129, 7, 8, 9, 31, 32,
                           33, 255, 256, 257) if 0 <= n <= B][:L]
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


def assert_native_extractor(clip, data, scope, want_slots):
    """The host stage of device_compress must be the C++ extractor: its
    Python fallback gives the same traces, so only this shows a library
    that failed to build or to parse."""
    stats = extract_traces(data, scope=scope, want_slots=want_slots)[4]
    if stats["native"] is not True:
        raise AssertionError(f"{clip} {scope}: the native extractor did not "
                             f"run (stats={stats})")


def phase_main_path(dev, Bs, clips):
    """The port's main path on real clips, held to the host codec."""
    datas = [open(os.path.join(ROOT, "data", c), "rb").read() for c in clips]
    for clip, data in zip(clips, datas):
        assert_native_extractor(clip, data, "gop", want_slots=False)
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


def bound_ms(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations"): every input byte read
    once and every output byte written once at the card's memory rate,
    against the integer operations at the card's rate for them."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_full_dispatch(dev, clips, L, B, card):
    p1u16, bitw, lens = tiled_problem(clips, L, B)
    t0 = time.time()
    streams = tlc.lane_streams_device_compact(p1u16, bitw, lens, dev)
    e2e = time.time() - t0
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, dev)
    tlc.lane_encode(*prob)  # warm-up
    k1 = cuda_ms(lambda: tlc.lane_encode(*prob), 5)
    ref = []
    plain = cuda_ms(lambda: ref.append(tlc.lane_encode_plain(*prob)), 1)
    k2 = cuda_ms(lambda: tlc.lane_encode(*prob), 5)
    raw = ref.pop()
    got = tlc.lane_encode(*prob)
    err = max_abs_diff(got, raw)
    if err or not all(torch.equal(a, b) for a, b in zip(got, raw)):
        raise AssertionError("full dispatch: kernel tokens != plain tokens")
    M = tlc.max_bytes(B)
    plain_streams = tlc.lane_collect(
        [(L, lens, (*tlc.finalize_device(*raw, M), raw))])
    if streams != plain_streams:
        raise AssertionError("full dispatch: kernel streams != plain streams")
    del raw, got
    nbytes = sum(map(len, streams))
    log(f"full dispatch [{L}, {B}]: kernel and plain tokens and streams "
        f"equal, {L * B} bins -> {nbytes} bytes; "
        f"lane_streams_device_compact {e2e:.3f} s host clock = "
        f"{L * B / e2e:.4g} bins/s end to end")
    ms = (k1 + k2) / 2
    # p1 and bit words in, tok and car out, lens/ftok/fcar a lane
    n_bytes = L * B * 2 + L * B // 8 + 2 * L * B * 4 + 3 * L * 4
    bound, by = bound_ms(n_bytes, LANE_OPS_PER_BIN * L * B)
    log(f"full dispatch timing [{L}, {B}] on {card}: kernel {k1:.3f} / "
        f"{k2:.3f} ms (mean {ms:.3f} ms), plain {plain:.1f} ms, kernel "
        f"{L * B / (ms / 1e3):.4g} bins/s; bound {bound:.3f} ms by {by} "
        f"({n_bytes} bytes), the kernel is at {bound / ms:.1%} of it; peak "
        f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return err, ms, plain, bound, by


SWEEP_LIMITS = (0x7FFF, 0x7FFE, 0x4000, 0x1000, 0x100, 0x60, 3, 0)


def est_problem(kind, S, T, NS, seed):
    """Est problem (numpy int32 slots, bits, pcabs, limits, valid, cls)
    from a seed.  "random": cls over all key classes, random halving
    limits; "skew": tests/test_pallas.py's carry stress (98% ones, one
    class, limit 0x60); "holes": invalid bins inside every trace, whole
    32-bin tiles among them; "tail": trace s has its only valid bins in the
    last three places of one tile; "oneslot": every bin hits slot NS - 1;
    "sweep": trace s hammers slot 0 with 99.5% ones under the halving limit
    SWEEP_LIMITS[s % 8], so that with T > 0x8000 the counters reach every
    limit and halve.  Row 0 has a ragged tail, and every third pcab is 0
    (no CABAC input)."""
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
        valid[:, 64:128] = 0
        valid[1::2, ::5] = 0
    elif kind == "tail":
        valid[:] = 0
        for s in range(S):
            tile = s % -(-T // 32)
            valid[s, tile * 32 + 29: tile * 32 + 32] = 1
    elif kind == "oneslot":
        slots[:] = NS - 1
    elif kind == "sweep":
        slots[:] = 0
        slots[:, ::50] = NS - 1
        bits = rng.random((S, T), dtype=np.float32) < 0.995
        limits[:, 0] = [SWEEP_LIMITS[s % len(SWEEP_LIMITS)] for s in range(S)]
    return slots, bits, pcabs, limits, valid, cls


# (kind, S, T, NS): the cases of the first est kernel, then what one warp
# per trace over 32-bin tiles can get wrong.  est_launch_plan puts 7, 6, 3,
# 2, 1 and 7 warps in a block at NS = 64, 512, 4096, 2108, 3494 and 30000,
# and keeps the rows in global scratch at 30000.
EST_CASES = [
    ("random", 64, 4096, 1024), ("skew", 64, 2048, 64),
    ("holes", 64, 2048, 512), ("random", 16, 2048, 4096),
    ("random", 3, 1000, 2108), ("random", 5, 517, 3494),
    ("random", 9, 777, 30000), ("holes", 10, 300, 30000),
    ("random", 4, 1, 8), ("random", 4, 5, 8), ("random", 4, 31, 8),
    ("random", 4, 33, 8), ("tail", 40, 250, 32), ("oneslot", 8, 1500, 8),
    ("oneslot", 3, 700, 30000),
]
EST_SWEEP = ("sweep", 8, 0x8000 + 64, 4)


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
        warps, rows_shared, smem = tec.est_launch_plan(NS)
        log(f"est kernel vs plain {kind} S={S} T={T} NS={NS} ({warps} warps "
            f"a block, rows in {'shared' if rows_shared else 'global'} "
            f"memory, {smem} B): max_abs_err={err} tokens="
            f"{int(ref[2].sum())} carries={carries} ff_bytes={ffs} "
            f"(first call {t_k:.3f} s, plain {t_p:.1f} s)")
        if err or not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"est kernel != plain for {kind} S={S} T={T}")
    return worst


def phase_est_main_path(dev, clips):
    """device_compress(substream_bins=0) on real clips, held to the host."""
    for k, clip in enumerate(clips):
        data = open(os.path.join(ROOT, "data", clip), "rb").read()
        for scope in ("slice", "gop"):
            assert_native_extractor(clip, data, scope, want_slots=True)
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


def est_kernel_only_ms(prob, reps):
    """The est kernel's own time on a checked problem (no range check, no
    zero fill), and the zero fill's, by CUDA events."""
    S, T = prob[0].shape
    tok = torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=prob[0].device)
    car = torch.zeros_like(tok)
    count = torch.zeros(S, dtype=torch.int32, device=tok.device)
    tec._launch(*prob, tok, car, count)  # warm-up
    kernel = cuda_ms(lambda: tec._launch(*prob, tok, car, count), reps)
    fill = cuda_ms(lambda: (tok.zero_(), car.zero_()), reps)
    return kernel, fill


def phase_est_full(dev, clips, S, card):
    """The clips' slice traces, whole, replicated to S traces: one
    encode_traces_est call, then kernel vs plain on the packed problem."""
    traces = []
    for c in clips:
        data = open(os.path.join(ROOT, "data", c), "rb").read()
        traces += native.extract(data, "slice", want_slots=True)[3]
    base = traces
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
    n_tokens = int(got[2].sum())
    ms = (k1 + k2) / 2
    kernel_only, fill = est_kernel_only_ms(prob, 3)
    check = cuda_ms(lambda: tec._check_problem(*prob), 3)
    # the six inputs in, the tokens this data emits and the counts out
    n_bytes = 4 * (4 * S * T + 2 * S * NS) + 8 * n_tokens + 4 * S
    bound, by = bound_ms(n_bytes, EST_OPS_PER_BIN * n_bins)
    log(f"est full size [{S}, {T}] NS={NS}: kernel and plain tokens equal, "
        f"{n_bins} bins -> {sum(map(len, streams))} bytes; "
        f"encode_traces_est {e2e:.3f} s host clock = {n_bins / e2e:.4g} "
        f"bins/s end to end")
    log(f"est full size timing [{S}, {T}] on {card}: est_encode {k1:.3f} / "
        f"{k2:.3f} ms (mean {ms:.3f} ms, {n_bins / (ms / 1e3):.4g} bins/s), "
        f"of which the kernel alone {kernel_only:.3f} ms, the zero fill of "
        f"tok and car {fill:.3f} ms, the range check {check:.3f} ms; plain "
        f"{plain:.1f} ms ({n_bins / (plain / 1e3):.4g} bins/s); bound "
        f"{bound:.3f} ms by {by} ({n_bytes} bytes, {n_tokens} tokens), "
        f"est_encode is at {bound / ms:.1%} of it")
    del got, ref, prob

    data = open(os.path.join(ROOT, "data", "mbaff_b.mkv"), "rb").read()
    longest = max(native.extract(data, "gop", want_slots=True)[3], key=len)
    prob = tec.from_numpy_traces(
        *tec.pack_rows([longest], 1, len(longest), len(longest.limits)), dev)
    one, _ = est_kernel_only_ms(prob, 3)
    log(f"est longest gop trace (mbaff_b.mkv, {len(longest)} bins, one "
        f"warp) on {card}: kernel alone {one:.3f} ms = "
        f"{one * 1e3 / len(longest):.3f} us/bin")

    # one trace replicated S times: what more traces cost the longest one
    longest = max(base, key=len)
    for reps in EST_SCALING:
        prob = tec.from_numpy_traces(*tec.pack_rows(
            [longest] * reps, reps, len(longest), len(longest.limits)), dev)
        t, _ = est_kernel_only_ms(prob, 3)
        log(f"est scaling S={reps} x {len(longest)} bins (NS="
            f"{len(longest.limits)}) on {card}: kernel alone {t:.3f} ms = "
            f"{t * 1e3 / len(longest):.3f} us per bin step, "
            f"{reps * len(longest) / (t / 1e3):.4g} bins/s")
        del prob
    return err, ms, plain, bound, by


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

    # 2 build: the host library and the kernels, together
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native.build)
        _build.load()
        t_k = time.time() - t0
        host_lib = host.result()
    if host_lib is None or not native.available():
        raise RuntimeError("libavtpu.so was not built (make and g++ needed)")
    log(f"build: lane_encode and est_encode kernels {t_k:.1f} s "
        f"({_build.library_path().name}); {host_lib.name} ready after "
        f"{time.time() - t0:.1f} s")
    log(_build.build_log().strip())

    # 3 kernel vs plain on the card
    err = phase_kernel_vs_plain(dev, [
        ("random", 1, 256), ("random", 5, 32), ("random", 33, 96),
        ("random", 70, 160), ("random", 31, 4128), ("random", 1000, 4096),
        ("carry", 1000, 4096), ("carry", 97, 1184), ("zero", 40, 512)])
    phase_overflow(dev, 1000, 4096)

    # 4 main path; the launch count covers exactly this phase
    tlc.lane_encode.launches = 0
    phase_main_path(dev, (4096, 16384), CLIPS)
    launches = tlc.lane_encode.launches
    log(f"main path: lane_encode.launches={launches}")
    if launches <= 0:
        raise AssertionError("main path never launched the lane_encode kernel")

    # 5 full-size dispatch: the kernel against plain at full width and depth
    full_lane_err, ms, plain_ms, lane_bound, lane_by = phase_full_dispatch(
        dev, CLIPS, FULL_L, FULL_B, card)

    # 6 est kernel vs plain on the card
    est_err = phase_est_kernel_vs_plain(dev, EST_CASES + [EST_SWEEP])

    # 7 est main path; the launch count covers exactly this phase
    tec.est_encode.launches = 0
    phase_est_main_path(dev, CLIPS)
    est_launches = tec.est_encode.launches
    log(f"est main path: est_encode.launches={est_launches}")
    if est_launches <= 0:
        raise AssertionError("est main path never launched the est_encode kernel")

    # 8 est full size
    full_err, est_ms, est_plain_ms, est_bound, est_by = phase_est_full(
        dev, CLIPS, EST_S, card)

    print(json.dumps({"kernels": [{
        "name": "lane_encode",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/lane_encode.cu",
        "replaces": "avrecode_tpu/ops/lane_coder.py:195",
        "launches": launches,
        "max_abs_err": max(err, full_lane_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": lane_bound,
        "bound_by": lane_by,
        "library_ms": None,  # no one PyTorch call computes a range coder
    }, {
        "name": "est_encode",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/est_encode.cu",
        "replaces": "avrecode_tpu/ops/pallas_coder.py:48",
        "launches": est_launches,
        "max_abs_err": max(est_err, full_err),
        "ms": est_ms,
        "plain_ms": est_plain_ms,
        "bound_ms": est_bound,
        "bound_by": est_by,
        "library_ms": None,  # nor an adaptive model with a range coder
    }]}))
    print(card)
    # the smoke drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
