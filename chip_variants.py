#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against the kernels in the
package, on one GPU.

    python3 chip_variants.py NAME=path/to/variant.cu[,-DFLAG...] ...

A variant is any source with the launcher of the kernel it varies:
`lane_encode_launch`, `lane_encode_streams_launch`,
`lane_encode_streams_idx_launch`, `unpack_p1_idx_launch`,
`est_encode_launch` or `lane_decode_launch`, with the signature of
avrecode_tpu_torch/csrc (which of the six is read from NAME: it starts with
"lane", "streams", "idx", "unpack", "est" or "decode").  Every variant is built with nvcc (sm_90a), all at
once; its outputs are held against the package's kernel on the same
tensors (exact), and both are timed with CUDA events, two windows each.  A
variant whose NAME holds "ablate" is one with a piece taken out on purpose
(csrc/lane_streams.cu has -DSTREAMS_NO_SETTLE and -DSTREAMS_NO_STORES): it is
timed, and its wrong output is reported but not refused.

  lane  one full dispatch group [8192, 16384] and the first 55 lanes of it
        (the pinned clips' real traces, tiled), and 1,000 ragged
        carry-stress lanes of 4,096 bins
  streams  the lane problems, through the fused kernel (M = B / 4 + 8;
        B + 8 on the carry-stress lanes); a variant must give the package
        kernel's nbytes, total and out[l, :nbytes[l]]
  idx   the same lanes in the index form (the full group packed from the
        tiled records by the native packer; the carry-stress lanes on the
        squash grid), through the fused kernel's index launcher, held to
        the package's index launcher; the `streams` kernels also run on the
        u16 form of these very lanes (their indices unpacked), so that
        both forms are timed, and held equal, on one set of lanes
  unpack  the idx lanes through unpack_p1_idx alone (exact p1)
  est   the clips' longest slice trace alone and 128 times, the clips'
        slice traces replicated to 1,024, and the archive cell's group of
        48 GOP-long traces (chip_smoke.archive_group)
  decode  the streams of that full dispatch group and of its first 55
        lanes, 1,000 ragged lanes of random bytes, and one lane of 64,096
        bins from the host encoder

With no arguments it times the package's kernels alone; with variants it
runs only the kinds they vary (an `idx` run also times the `streams`
kernels on its lanes' u16 form).  This is a tool for kernel work, not a
benchmark: one card, no spread.
"""

import ctypes
import os
import subprocess
import sys

import torch

from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import _build
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.ops import lane_decoder as tld
from chip_smoke import (
    CLIPS, ROOT, archive_group, archive_problem, card_line, cuda_ms,
    decode_problem, lanes, log, one_long_lane, squash_lanes, streams_diff,
    tiled_problem, tiled_trace)

PTR = ctypes.c_void_p
OUT_DIR = os.path.join(ROOT, "build", "variants")


def build_all(variants):
    """{name: (source, flags)} -> {name: CDLL}, all compiled together."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        out = os.path.join(OUT_DIR, name + ".so")
        cmd = _build.nvcc_command(out, [src], flags)
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        log(name, *[ln.strip() for ln in text.splitlines() if "registers" in ln])
        libs[name] = ctypes.CDLL(out)
    return libs


def lane_runner(lib):
    lib.lane_encode_launch.argtypes = [PTR] * 7 + [ctypes.c_int] * 2 + [PTR]
    lib.lane_encode_launch.restype = ctypes.c_int

    def run(prob, out):
        L, Bp = prob[0].shape
        err = lib.lane_encode_launch(
            *(t.data_ptr() for t in (*prob, *out)), L, Bp,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lane_encode_launch: cudaError {err}")

    return run


def streams_runner(lib):
    lib.lane_encode_streams_launch.argtypes = (
        [PTR] * 6 + [ctypes.c_int] * 3 + [PTR])
    lib.lane_encode_streams_launch.restype = ctypes.c_int

    def run(prob, out):
        L, Bp = prob[0].shape
        err = lib.lane_encode_streams_launch(
            *(t.data_ptr() for t in (*prob, *out)), L, Bp, out[0].shape[1],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lane_encode_streams_launch: cudaError {err}")

    return run


def idx_runner(lib):
    lib.lane_encode_streams_idx_launch.argtypes = (
        [PTR] * 7 + [ctypes.c_int] * 3 + [PTR])
    lib.lane_encode_streams_idx_launch.restype = ctypes.c_int

    def run(prob, out):
        p1pk, bitw, lens = prob[:3]
        L, Bp = p1pk.shape[0], tlc.lane_bins(p1pk)
        err = lib.lane_encode_streams_idx_launch(
            p1pk.data_ptr(), tlc._squash_on(p1pk.device).data_ptr(),
            *(t.data_ptr() for t in (bitw, lens, *out)), L, Bp,
            out[0].shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lane_encode_streams_idx_launch: cudaError "
                               f"{err}")

    return run


def unpack_runner(lib):
    lib.unpack_p1_idx_launch.argtypes = [PTR] * 3 + [ctypes.c_longlong, PTR]
    lib.unpack_p1_idx_launch.restype = ctypes.c_int

    def run(prob, out):
        pk = prob[0]
        err = lib.unpack_p1_idx_launch(
            pk.data_ptr(), tlc._squash_on(pk.device).data_ptr(),
            out[0].data_ptr(), pk.shape[0] * tlc.lane_bins(pk) // 8,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"unpack_p1_idx_launch: cudaError {err}")

    return run


def streams_equal(out, ref):
    """Two (out, nbytes, total): equal where the bytes are specified."""
    return streams_diff(out, ref, out[0].shape[1]) == 0


def est_runner(lib):
    lib.est_encode_launch.argtypes = [PTR] * 14 + [ctypes.c_int] * 6 + [PTR]
    lib.est_encode_launch.restype = ctypes.c_int

    def run(prob, out):
        slots, bits, pcabs, limits, valid, cls = prob
        S, T = slots.shape
        NS = limits.shape[1]
        traces, rows_shared, smem = tec.est_launch_plan(NS)
        rows = torch.empty((0 if rows_shared else S, NS), dtype=torch.int64,
                           device=slots.device)
        err = lib.est_encode_launch(
            *(t.data_ptr() for t in (slots, bits, pcabs, valid, limits, cls,
                                     *tec._kernel_tables(slots.device), *out,
                                     rows)),
            None, S, T, NS, traces, int(rows_shared), smem,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"est_encode_launch: cudaError {err}")

    return run


def decode_runner(lib):
    lib.lane_decode_launch.argtypes = (
        [PTR, ctypes.c_longlong] + [PTR] * 4 + [ctypes.c_int] * 2 + [PTR])
    lib.lane_decode_launch.restype = ctypes.c_int

    def run(prob, out):
        stream, offs, p1u16, lens = prob
        L, Bp = p1u16.shape
        err = lib.lane_decode_launch(
            stream.data_ptr(), stream.numel(), offs.data_ptr(),
            p1u16.data_ptr(), lens.data_ptr(), out[0].data_ptr(), L, Bp,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lane_decode_launch: cudaError {err}")

    return run


def compare(kind, problems, runners, make_out, steps, same=None):
    """Run every runner on every problem; the first one is the reference.
    same(out, ref): the comparison, where not every byte is specified."""
    for label, prob in problems.items():
        ref = None
        for name, run in runners.items():
            out = make_out(prob)
            run(prob, out)
            torch.cuda.synchronize()
            if ref is None:
                ref = [t.clone() for t in out]
            equal = (same(out, ref) if same else
                     all(torch.equal(a, b) for a, b in zip(out, ref)))
            t1, t2 = (cuda_ms(lambda: run(prob, out), 5) for _ in range(2))
            log(f"{kind} {label} {name}: {t1:.4f} / {t2:.4f} ms, "
                f"{t1 * 1e3 / steps(prob):.4f} us a bin step, "
                f"equal to {next(iter(runners))}: {equal}")
            if not equal and "ablate" not in name:
                raise AssertionError(f"{name} differs on {label}")


def main(argv):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_variants.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(card_line())
    csrc = os.path.join(ROOT, "avrecode_tpu_torch", "csrc")
    variants = {"lane_package": (os.path.join(csrc, "lane_encode.cu"), []),
                "streams_package": (os.path.join(csrc, "lane_streams.cu"), []),
                "idx_package": (os.path.join(csrc, "lane_streams.cu"), []),
                "unpack_package": (os.path.join(csrc, "p1_idx.cu"), []),
                "est_package": (os.path.join(csrc, "est_encode.cu"), []),
                "decode_package": (os.path.join(csrc, "lane_decode.cu"), [])}
    every = ("lane", "streams", "idx", "unpack", "est", "decode")
    kinds = set(every)
    if argv:
        kinds = set()
    for arg in argv:
        name, spec = arg.split("=", 1)
        src, *flags = spec.split(",")
        variants[name] = (src, flags)
        kinds.add(next(k for k in every if name.startswith(k)))
    variants = {n: v for n, v in variants.items()
                if any(n.startswith(k) for k in kinds)
                or (n.startswith("streams") and "idx" in kinds)}
    libs = build_all(variants)
    if kinds & {"lane", "streams"}:
        lane_and_streams(libs, dev, kinds)
    if kinds & {"idx", "unpack"}:
        idx_kind(libs, dev, kinds)
    if "decode" in kinds:
        decode_kind(libs, dev)
    if "est" in kinds:
        est_kind(libs, dev)


def lane_and_streams(libs, dev, kinds):
    lane = {n: lane_runner(lib) for n, lib in libs.items() if n.startswith("lane")}
    full = tiled_problem(CLIPS, 8192, 16384)
    problems = {
        "[8192, 16384]": tlc.from_numpy_problem(*full, dev),
        "[55, 16384]": tlc.from_numpy_problem(*(a[:55] for a in full), dev),
        "ragged carry [1000, 4096]": tlc.from_numpy_problem(
            *lanes("carry", 1000, 4096, 3), dev),
    }

    def lane_out(prob):
        L, Bp = prob[0].shape
        return (torch.empty((L, Bp), dtype=torch.int32, device=dev),
                torch.empty((L, Bp), dtype=torch.int32, device=dev),
                torch.empty(L, dtype=torch.int32, device=dev),
                torch.empty(L, dtype=torch.int32, device=dev))

    if "lane" in kinds:
        compare("lane", problems, lane, lane_out, lambda p: p[0].shape[1])

    fused = {n: streams_runner(lib) for n, lib in libs.items()
             if n.startswith("streams")}
    if "streams" in kinds:
        compare("streams", problems, fused, streams_out,
                lambda p: p[0].shape[1], same=streams_equal)


def streams_out(prob):
    L, Bp = prob[0].shape[0], tlc.lane_bins(prob[0])
    M = tlc.max_bytes(Bp, 4 if Bp == 16384 else 1)
    dev = prob[0].device
    return (torch.zeros((L, M), dtype=torch.uint8, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev))


def idx_kind(libs, dev, kinds):
    fused = {n: streams_runner(lib) for n, lib in libs.items()
             if n.startswith("streams")}
    # an index problem carries its lanes' u16 form as a fourth tensor: the
    # streams kernels run on (p1, bitw, lens) of the very same lanes
    idx = {n: idx_runner(lib) for n, lib in libs.items() if n.startswith("idx")}
    for n, run in fused.items():
        idx[f"{n} (u16 form)"] = (
            lambda prob, out, run=run: run((prob[3], *prob[1:3]), out))

    def with_u16(pk, bitw, lens):
        prob = tlc.from_numpy_problem(pk, bitw, lens, dev)
        return (*prob, tlc.unpack_p1_idx_plain(prob[0]))

    pk, bitw, lens, _ = tlc.pack_lanes([tiled_trace(CLIPS, 8192, 16384)],
                                       16384)
    problems = {
        "[8192, 16384]": with_u16(pk, bitw, lens),
        "[55, 16384]": with_u16(pk[:55], bitw[:55], lens[:55]),
        "ragged carry [1000, 4096]": with_u16(
            *squash_lanes("carry", 1000, 4096, 3)),
    }
    del pk, bitw, lens

    if "idx" in kinds:
        compare("idx", problems, idx, streams_out,
                lambda p: tlc.lane_bins(p[0]), same=streams_equal)
    if "unpack" in kinds:
        unpack = {n: unpack_runner(lib) for n, lib in libs.items()
                  if n.startswith("unpack")}
        compare("unpack", problems, unpack,
                lambda p: (torch.empty(p[3].shape, dtype=torch.uint16,
                                       device=dev),),
                lambda p: tlc.lane_bins(p[0]))


def decode_kind(libs, dev):
    decode = {n: decode_runner(lib) for n, lib in libs.items()
              if n.startswith("decode")}
    full = tiled_problem(CLIPS, 8192, 16384)
    streams = tlc.lane_streams_device_compact(*full, dev)
    problems = {
        "[8192, 16384]": tld.from_numpy_problem(
            *tld.pack_streams(streams), full[0], full[2], dev),
        "[55, 16384]": tld.from_numpy_problem(
            *tld.pack_streams(streams[:55]), full[0][:55], full[2][:55], dev),
        "ragged bytes [1000, 4096]": decode_problem(
            "bytes", 1000, 4096, 3, dev)[0],
        "host encoder [1, 64096]": one_long_lane(64096, 11, dev)[0],
    }

    def decode_out(prob):
        L, Bp = prob[2].shape
        return (torch.empty((L, Bp // 32), dtype=torch.int32, device=dev),)

    compare("decode", problems, decode, decode_out, lambda p: p[2].shape[1])


def est_kind(libs, dev):
    est = {n: est_runner(lib) for n, lib in libs.items() if n.startswith("est")}
    traces = []
    for clip in CLIPS:
        with open(os.path.join(ROOT, "data", clip), "rb") as f:
            traces += native.extract(f.read(), "slice", want_slots=True)[3]
    longest = max(traces, key=len)
    problems = {}
    for label, ts in (("one trace", [longest]), ("128 copies", [longest] * 128),
                      ("1,024 mixed", (traces * -(-1024 // len(traces)))[:1024])):
        T = max(map(len, ts))
        NS = max(len(t.limits) for t in ts)
        problems[f"{label} [{len(ts)}, {T}] NS={NS}"] = tec.from_numpy_traces(
            *tec.pack_rows(ts, len(ts), T, NS), dev)
    prob = archive_problem(dev, archive_group())
    S, T = prob[0].shape
    problems[f"archive group [{S}, {T}] NS={prob[3].shape[1]}"] = prob

    def est_out(prob):
        S, T = prob[0].shape
        return (torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=dev),
                torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=dev),
                torch.zeros(S, dtype=torch.int32, device=dev))

    compare("est", problems, est, est_out, lambda p: p[0].shape[1])


if __name__ == "__main__":
    main(sys.argv[1:])
