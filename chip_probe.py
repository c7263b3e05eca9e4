#!/usr/bin/env python3
"""Where each warp of the fused lane kernel spends its cycles, on one GPU.

    python3 chip_probe.py [path/to/lane_streams.cu]

Writes an instrumented copy of the kernel source (by default the package's
avrecode_tpu_torch/csrc/lane_streams.cu) under build/probe/: clock64()
counters, summed over the warps by atomics into a __device__ array, around
each role's whole run and around every wait of the hand-over (the chain
warp's P1FULL and EMPTY, the stream warp's FULL, the producer's P1EMPTY).
It builds the copy with the package's nvcc flags, runs the index launcher
and the u16 launcher on the same lanes (chip_variants.py's idx sets: the
full group, its first 55 lanes, 1,000 ragged carry lanes), three launches
each after a warm-up, and prints each role's mean cycles a warp: its whole
run and its waits.  The kernel time on the same launches (CUDA events)
gives the clock the chain warp ran at.  The counters cost a few percent;
compare roles within one run, not with an uninstrumented kernel.

The copy is made by replacing exact lines of the source: a source whose
hand-over lines differ fails here, loudly, and this script has to follow
it.  A tool for kernel work, not a benchmark: one card, no spread.
"""

import ctypes
import os
import subprocess
import sys

import torch

from avrecode_tpu_torch.ops import _build
from avrecode_tpu_torch.ops import lane_coder as tlc
from chip_smoke import CLIPS, ROOT, card_line, log, squash_lanes, tiled_trace
from chip_variants import idx_runner, streams_out, streams_runner

OUT_DIR = os.path.join(ROOT, "build", "probe")
SLOTS = 16  # counters: 0-3 waits, 4-6 idx role totals, 8-10 idx warps,
# 12-13 u16 role totals, 14-15 u16 warps

HEADER = """__device__ unsigned long long g_probe[16];
namespace {
#define PROBE(slot, expr) do { const long long t0_ = clock64(); expr; \\
  if ((threadIdx.x & 31) == 0) \\
    atomicAdd(&g_probe[slot], (unsigned long long)(clock64() - t0_)); \\
  } while (0)
#define PROBE_ROLE(slot, n_slot) do { if ((threadIdx.x & 31) == 0) { \\
    atomicAdd(&g_probe[slot], (unsigned long long)(clock64() - t_start)); \\
    atomicAdd(&g_probe[n_slot], 1ull); } } while (0)
"""

READ = """
extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
  unsigned long long zero[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""

# (line as in the source, its instrumented form)
EDITS = [
    ("namespace {\n", HEADER),
    ("      bar_sync(bar + kBarP1Full + (t & 1));\n",
     "      PROBE(0, bar_sync(bar + kBarP1Full + (t & 1)));\n"),
    ("    if (t >= 2) bar_sync(bar + kBarEmpty + (t & 1));"
     "  // the stream warp read t - 2\n",
     "    if (t >= 2) PROBE(1, bar_sync(bar + kBarEmpty + (t & 1)));\n"),
    ("    bar_sync(bar + kBarFull + (t & 1));\n    const int b0",
     "    PROBE(2, bar_sync(bar + kBarFull + (t & 1)));\n    const int b0"),
    ("    if (t >= 2) mbar_wait(prod.p1empty + (t & 1), ((t >> 1) - 1) & 1);\n",
     "    if (t >= 2) PROBE(3, mbar_wait(prod.p1empty + (t & 1), "
     "((t >> 1) - 1) & 1));\n"),
    # the u16 kernel: its two roles' whole runs
    ("  if (threadIdx.x < 32)\n    chain_warp<false>(",
     "  const long long t_start = clock64();\n"
     "  if (threadIdx.x < 32)\n    chain_warp<false>("),
    ("                       rows, n_valid, nt, Bp, M);\n}\n",
     "                       rows, n_valid, nt, Bp, M);\n"
     "  PROBE_ROLE(12 + (threadIdx.x >> 5), 14 + (threadIdx.x >> 5));\n}\n"),
    # the index kernel: chain 0, stream 1, producer 3 (counted as 2)
    ("  if (role == 0)\n    chain_warp<true>(",
     "  const long long t_start = clock64();\n"
     "  if (role == 0)\n    chain_warp<true>("),
    ("                           lane0, rows, nt, Bp});\n}\n",
     "                           lane0, rows, nt, Bp});\n"
     "  PROBE_ROLE(4 + min(role, 2), 8 + min(role, 2));\n}\n"),
]


def instrument(src):
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"chip_probe.py: the source has {src.count(old)}"
                               f" copies of the line {old!r}, not one")
        src = src.replace(old, new)
    return src + READ


def build(path):
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, "lane_streams_probe.cu")
    with open(path) as f:
        text = instrument(f.read())
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(OUT_DIR, "lane_streams_probe.so")
    cmd = _build.nvcc_command(out, [src], ["-I", os.path.dirname(
        os.path.abspath(path))])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.probe_read.restype = ctypes.c_int
    return lib


def main(argv):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_probe.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(card_line())
    path = argv[0] if argv else os.path.join(
        ROOT, "avrecode_tpu_torch", "csrc", "lane_streams.cu")
    lib = build(path)
    runs = {"index": idx_runner(lib), "u16": streams_runner(lib)}
    buf = (ctypes.c_ulonglong * SLOTS)()
    pk, bitw, lens, _ = tlc.pack_lanes([tiled_trace(CLIPS, 8192, 16384)],
                                       16384)
    sets = {"[8192, 16384]": (pk, bitw, lens),
            "[55, 16384]": (pk[:55], bitw[:55], lens[:55]),
            "ragged carry [1000, 4096]": squash_lanes("carry", 1000, 4096, 3)}
    for label, arrays in sets.items():
        prob = tlc.from_numpy_problem(*arrays, dev)
        forms = {"index": prob,
                 "u16": (tlc.unpack_p1_idx_plain(prob[0]), *prob[1:])}
        out = streams_out(prob)
        for form, run in runs.items():
            run(forms[form], out)
            torch.cuda.synchronize()
            lib.probe_read(buf)  # the warm-up's counts are dropped
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(3):
                run(forms[form], out)
            e1.record()
            torch.cuda.synchronize()
            if lib.probe_read(buf):
                raise RuntimeError("chip_probe.py: reading the counters failed")
            ms = e0.elapsed_time(e1) / 3
            v = list(buf)
            if form == "index":
                n = [max(x, 1) for x in v[8:11]]
                chain = v[4] / n[0]
                log(f"probe {label} index form: {ms:.4f} ms a launch; mean "
                    f"cycles a warp: chain {chain:.0f} (waits P1FULL "
                    f"{v[0] / n[0]:.0f}, EMPTY {v[1] / n[0]:.0f}), stream "
                    f"{v[5] / n[1]:.0f} (waits FULL {v[2] / n[1]:.0f}), "
                    f"producer {v[6] / n[2]:.0f} (waits P1EMPTY "
                    f"{v[3] / n[2]:.0f}); chain clock {chain / ms / 1e6:.3f} "
                    f"GHz")
            else:
                n = [max(x, 1) for x in v[14:16]]
                chain = v[12] / n[0]
                log(f"probe {label} u16 form: {ms:.4f} ms a launch; mean "
                    f"cycles a warp: chain {chain:.0f} (waits EMPTY "
                    f"{v[1] / n[0]:.0f}), stream {v[13] / n[1]:.0f} (waits "
                    f"FULL {v[2] / n[1]:.0f}); chain clock "
                    f"{chain / ms / 1e6:.3f} GHz")


if __name__ == "__main__":
    main(sys.argv[1:])
