#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against the kernels in the
package, on one GPU.

    python3 chip_variants.py NAME=path/to/variant.cu[,-DFLAG...] ...

A variant is any source with the launcher of the kernel it varies:
`lane_encode_launch` or `est_encode_launch`, with the signature of
avrecode_tpu_torch/csrc (which of the two is read from NAME: it starts
with "lane" or "est").  Every variant is built with nvcc (sm_90a), all at
once; its outputs are held against the package's kernel on the same
tensors (exact), and both are timed with CUDA events, two windows each:

  lane  one full dispatch group [8192, 16384] and the first 55 lanes of it
        (the pinned clips' real traces, tiled), and 1,000 ragged
        carry-stress lanes of 4,096 bins
  est   the clips' longest slice trace alone and 128 times, and the clips'
        slice traces replicated to 1,024

With no arguments it times the package's kernels alone.  This is a tool for
kernel work, not a benchmark: one card, no spread.
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
from chip_smoke import CLIPS, ROOT, card_line, cuda_ms, lanes, log, tiled_problem

PTR = ctypes.c_void_p
OUT_DIR = os.path.join(ROOT, "build", "variants")


def build_all(variants):
    """{name: (source, flags)} -> {name: CDLL}, all compiled together."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        out = os.path.join(OUT_DIR, name + ".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out, src]
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


def est_runner(lib):
    lib.est_encode_launch.argtypes = [PTR] * 13 + [ctypes.c_int] * 6 + [PTR]
    lib.est_encode_launch.restype = ctypes.c_int

    def run(prob, out):
        slots, bits, pcabs, limits, valid, cls = prob
        S, T = slots.shape
        NS = limits.shape[1]
        warps, rows_shared, smem = tec.est_launch_plan(NS)
        rows = torch.empty((0 if rows_shared else S, NS), dtype=torch.int64,
                           device=slots.device)
        err = lib.est_encode_launch(
            *(t.data_ptr() for t in (slots, bits, pcabs, valid, limits, cls,
                                     *tec._kernel_tables(slots.device), *out,
                                     rows)),
            S, T, NS, warps, int(rows_shared), smem,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"est_encode_launch: cudaError {err}")

    return run


def compare(kind, problems, runners, make_out, steps):
    """Run every runner on every problem; the first one is the reference."""
    for label, prob in problems.items():
        ref = None
        for name, run in runners.items():
            out = make_out(prob)
            run(prob, out)
            torch.cuda.synchronize()
            if ref is None:
                ref = [t.clone() for t in out]
            equal = all(torch.equal(a, b) for a, b in zip(out, ref))
            t1, t2 = (cuda_ms(lambda: run(prob, out), 5) for _ in range(2))
            log(f"{kind} {label} {name}: {t1:.4f} / {t2:.4f} ms, "
                f"{t1 * 1e3 / steps(prob):.4f} us a bin step, "
                f"equal to {next(iter(runners))}: {equal}")
            if not equal:
                raise AssertionError(f"{name} differs on {label}")


def main(argv):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_variants.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(card_line())
    csrc = os.path.join(ROOT, "avrecode_tpu_torch", "csrc")
    variants = {"lane_package": (os.path.join(csrc, "lane_encode.cu"), []),
                "est_package": (os.path.join(csrc, "est_encode.cu"), [])}
    for arg in argv:
        name, spec = arg.split("=", 1)
        src, *flags = spec.split(",")
        variants[name] = (src, flags)
    libs = build_all(variants)

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

    compare("lane", problems, lane, lane_out, lambda p: p[0].shape[1])
    del problems, full

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

    def est_out(prob):
        S, T = prob[0].shape
        return (torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=dev),
                torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=dev),
                torch.zeros(S, dtype=torch.int32, device=dev))

    compare("est", problems, est, est_out, lambda p: p[0].shape[1])


if __name__ == "__main__":
    main(sys.argv[1:])
