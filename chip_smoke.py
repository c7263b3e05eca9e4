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
             multiple of the tile, a carry-stress case.  Then
             lane_encode_streams (the fused CUDA kernel) vs
             lane_encode_streams_plain and vs the host finalize of
             lane_encode's tokens, exact on every lane's out[:nbytes], on
             nbytes and on total: those problems, carry stress at B of 64,
             257 and 4096, runs of 0xFF longer than the kernel's staging
             ring with one carry through them into position 0, lens of 0,
             1 and B, 1, 15, 17 and 1,000 lanes, bits_per_byte of 1, 4 and
             1000, lane counts on the edges of both kernels' blocks (the
             index kernel's one or two lane groups, 4,224 lanes where it
             changes on 132 SMs), one long lane in every 64 among short
             ones.  Then the index form: lane_encode_streams_idx vs
             lane_encode_streams_idx_plain and vs lane_encode_streams on
             the same lanes, on those cases with p1 on the squash table's
             image (every index 0-4095 among the valid bins of the larger
             ones, padding index 0), and one lane of 32,768 bins against
             the host encoder; unpack_p1_idx vs its plain version on each.
             A valid p1 = 0 takes the u16 form.  Then the overflow path in
             both forms: dense streams past the bound are coded again by
             lane_encode (an index-form group unpacked by unpack_p1_idx
             first) and finalized on the host
  4 main     device_compress on the pinned clips (a CAVLC one among them)
             at gop scope and B in (4096, 16384): byte-identical to
             codec.compress and roundtripping through both decoders;
             device_compress_corpus equal to the per-file results; every
             call launched lane_encode_streams_idx (the index form, which
             native traces take) and no other lane kernel; then
             lane_streams_device_compact on p1 off the squash image takes
             the u16 form, lane_encode_streams; then phase 15's corpus
             through device_compress_corpus at B = 4096, ~8 dispatch
             groups a pass against a staging ring of 2 a form, twice (the
             second time behind a sleep kernel, so that every upload waits
             and a buffer refilled under its copy would send wrong rows):
             every pass's containers equal the first's and codec.compress
  5 full     one full dispatch group, [8192, 16384] lanes tiled from the
             clips' real (bit, p1) traces, in both upload forms (the index
             form from the native packer): lane_encode vs plain (equal
             tokens), lane_encode_streams and lane_encode_streams_idx vs
             plain (equal streams), unpack_p1_idx vs plain, all timed with
             CUDA events, each kernel's time beside its bounds;
             lane_streams_device_compact whole and stage by stage (upload,
             kernel, read-back, slicing) in both forms
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
             decoders; the est kernel must have launched, and est_unpack
             (the records unpacked into its rows) once a launch
  8 full     the clips' slice traces replicated to 1,024 traces in one
             encode_traces_est call; the kernel on that problem against
             the plain version run once on the distinct base traces: every
             kernel row equal to its base row's tokens, both timed with
             CUDA events, the kernel's time beside its bound (phase 5's
             tiled lanes repeat no row, so its plain versions run whole);
             the kernel alone on the longest gop trace
             and on the longest slice trace replicated 1, 128 and 1,024 times;
             then the archive cell's est group (the benchmark's four camera
             GOPs at gop scope, repeated to the 48 GOP-long traces of its
             longest recording, [48, ~7.4M]):
             est_unpack's rows equal to pack_rows' and to est_unpack_plain's,
             exactly, and its launch alone (pointer table and rows made
             before) timed with CUDA events beside its bound
  9 kernel   lane_decode (CUDA kernel) vs lane_decode_plain on the same card
             tensors, exact: the phase-3 problems encoded on the card by
             lane_encode + finalize and decoded again (bits equal to the
             bits that went in), lane counts off a warp's 16, widths off
             the 128-bin tile, streams of 0-3 bytes, random bytes with
             p1 = 0 and 0xFFFF, and lanes of more than 65,536 bins
  10 main    device_decompress on containers of three pinned clips (gop
             scope, B = 4096), and for two of them a v1 container and a
             slice-scope one with B = 512: equal to the original file and
             to codec.decompress; the decode kernel must have launched;
             then the same containers phase by phase: the device's bins
             equal the host model pass's, and the stage split is printed
  11 full    phase 5's [8192, 16384] group: its streams through
             lane_decode give the group's input bits; kernel vs plain,
             both timed with CUDA events, the kernel's time beside its
             bound; the longest pinned v1 unit (one lane) timed alone;
             entry()'s step on the card equals the host finalize
  12 mesh    device_compress(mesh=make_mesh(n, device=dev)) for n in
             (1, 2, 4, 7) on the six pinned clips (gop scope, B = 4096):
             equal to the call without a mesh and to codec.compress,
             roundtripping; the est path with n = 4 on two clips equal to
             native.compress; sharded decode_streams_lanes equal to the
             unsharded call; the mesh cuts traces, and every non-empty
             shard launched its kernel once (lane_encode_streams_idx on
             the lane path; est_encode and est_unpack on the est path).
             Then phase 5's [8192, 16384] group as numpy rows cut over
             the mesh's shard loop (run_sharded), each shard through a
             LaneBatcher, with n = 4: streams equal to the single launch's, the
             whole call on the host clock and the kernels by CUDA events
             beside the unsharded call's, and dispatch and drain of both.
             Where the machine has more than one card, also make_mesh()
             over the distinct cards
  13 ranks   dryrun_multichip(4) on the card (its own asserts);
             multichip_step over 2 ranks equal to the single-process est
             result on rt_ctr.mkv's slice traces; 2 ranks under
             init_distributed running compress_sharded / stitch and
             decompress_sharded / stitch_decompressed on mbaff_b.mkv.
             Prints the backend, the compute mode, and the time of
             start-up, work and collectives apart; every rank launched
             its kernel
  14 cli     python -m avrecode_tpu_torch roundtrip, then compress with
             --hosts 2 and decompress: exit codes 0, bytes equal
  15 bench   python -m avrecode_tpu_torch.bench --device-corpus on the
             pinned clips and conformance streams, repeated until the
             corpus passes two full dispatch groups at the bench's B:
             every container roundtrips, the CUDA lane kernel coded it,
             three or more dispatches, the fused kernel launched once a
             dispatch in every pass, the card named; prints each pass's
             lane pack summed over the extraction workers and its rows'
             copy on the main thread, then the bench's line (its per-file
             entries counted, not listed)
  16 verify  python3 tools/gpu_verify.py --out <a temporary file>: exit
             code 0 and every check ok (each compress check through either
             fused launcher, the off-image lanes through lane_encode_streams
             alone); the committed GPU_VERIFY.json is left as it is
The last three lines are a JSON line of kernel numbers, the card's name
and power limit, and {"ok": true, "device": {...}}.  A kernel's `launches`
there is the sum over the main paths that run it (`launches_by_path`), each
counted from 0 just before the path to just after it.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from avrecode_tpu_torch import bench, codec, graft_entry
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import _build
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.ops import lane_decoder as tld
from avrecode_tpu_torch.ops.estimator import stream_bytes
from avrecode_tpu_torch.ops.rangecoder import RangeEncoder
from avrecode_tpu_torch.parallel import mesh as tmesh
from avrecode_tpu_torch.parallel import multihost, ranks
from avrecode_tpu_torch.parallel import pipeline as tpipe
from avrecode_tpu_torch.parallel.pipeline import (
    device_compress, device_compress_corpus, device_decompress,
    extract_traces, make_mesh)

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "rt_ctr.ts", "rt_ctr.avi",
         "rt_ctr.flv", "rt_ctr.mpg"]
FULL_L, FULL_B = 8192, 16384  # one full dispatch group at the bench's B
EST_S = 1024  # traces of the phase-8 est problem
ARCHIVE_S = 48  # GOP-long traces of the archive cell's longest recording
EST_SCALING = (1, 128, 1024)  # copies of one trace, kernel alone
# the card's peaks for the bounds (NVIDIA H100 SXM data sheet): memory
# rate, and integer operations at half the 67 TFLOP/s float32 rate (an SM
# has half as many int32 lanes as float32 lanes)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# Integer operations of each lane algorithm, counted on RangeEncoder.put /
# RangeDecoder.get (ops/rangecoder.py; 32-bit arithmetic, so the masks are
# free, and a branch counts as one select), whatever a kernel's SASS spends.
# A bin costs a fixed part.  A renorm step (the `while rng < TOP` loop) costs
# a part of its own and moves one byte, so a run's steps are its stream
# bytes (0.08 a bin on real traces), not the two a bin that the vectorised
# plain versions compute and select away.  (ops a bin, ops a step):
# - lane_encode: a bin r1 2 (shift, multiply), low's add with its carry
#   test and count 3, rng's subtract 1, three selects by the bit 3, the
#   loop's test 1, the token and carry count packed and stored 4: 14; a step
#   the byte 1, its carry count and the reset 2, low and rng shifts 2, the
#   next test 1, the byte and its count into the token 2: 8
# - lane_encode_streams: a bin the coder's 10; a step the coder's 6, the
#   byte stored at the stream's position and the position moved 2, its carry
#   count added onto the byte before 1, the trailing-zero and truncation
#   scans 1: 10
# - lane_decode: a bin r1 2, compare 1, code's and rng's subtracts 2 and
#   selects 2, the loop's test 1, the bit packed 2: 10; a step code and rng
#   shifts 2, the byte read with its end test 2, or 1, position add 1, the
#   next test 1: 7
LANE_OPS = (14, 8)
STREAM_OPS = (10, 10)
# - lane_encode_streams_idx: the fused kernel's, and a bin's 12-bit field
#   taken out (shift and mask) and looked up in the table: 12 a bin
# - unpack_p1_idx: that field and lookup, 2 a bin (the packing of two p1 into
#   a word and the stores are data movement, counted as bytes)
STREAM_IDX_OPS = (12, 10)
UNPACK_OPS = 2
DECODE_OPS = (10, 7)
EST_OPS_PER_BIN = 150  # of one est_encode bin
# dependent instructions of one lane_decode bin (shift, multiply, compare
# and select, find leading bit and mask, shift), in cycles as
# chip_latency.cu reads them, and the clock it ran at: a lane's floor,
# whatever the lane count
DECODE_CHAIN_CYCLES = 53
SM_CLOCK_HZ = 1.98e9
MAIN_CLIPS = CLIPS + ["cavlc_ipp.mkv"]  # phase 4: a CAVLC stream too
# phase 15: every pinned clip and conformance stream, repeated
BENCH_SET = MAIN_CLIPS + ["rt_ctr.mp4"] + [n for n, _ in bench.CONFORMANCE]
BENCH_GROUPS = 2  # full dispatch groups the phase-15 corpus passes
RING_B = 4096  # the ring check's B: ~8 dispatch groups a pass of that corpus
RING_STALL_CYCLES = 16_000_000_000  # ~8 s of the card's clock
RING_PEAK_GROUPS = 3  # a corpus pass's device peak: under 3 groups' inputs
RSS_EVERY_S = 0.005  # PeakRSS's sampling period
BENCH_TIMEOUT_S = 420
VERIFY_TIMEOUT_S = 600  # tools/gpu_verify.py, start-up included
MESH_SHARDS = (1, 2, 4, 7)  # shard counts of phase 12 on one card
MESH_FULL = 4  # shards of the full group, and of the est path
MESH_B = 4096
EST_MESH_CASES = [(c, s) for c in ("rt_ctr.mkv", "mbaff_b.mkv")
                  for s in ("slice", "gop")]
# (clip, scope, substream_bins) of the phase-10 containers; 0 = v1
DECODE_CONTAINERS = [(c, "gop", 4096) for c in CLIPS[:3]] + [
    ("rt_ctr.mkv", "gop", 0), ("mbaff_b.mkv", "gop", 0),
    ("rt_ctr.mkv", "slice", 512), ("mbaff_b.mkv", "slice", 512)]


def log(*args):
    print(*args, flush=True)


class PeakRSS:
    """The process's peak resident set while the block runs, sampled from
    /proc/self/status (VmRSS) on a thread every RSS_EVERY_S: `before` and
    `peak` in bytes."""

    def __init__(self):
        self.before = self.peak = 0
        self._stop = threading.Event()

    @staticmethod
    def now():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _sample(self):
        while not self._stop.wait(RSS_EVERY_S):
            self.peak = max(self.peak, self.now())

    def __enter__(self):
        self.before = self.peak = self.now()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())

    def text(self):
        return (f"peak RSS {self.peak / 1e9:.3f} GB ({self.before / 1e9:.3f} "
                "GB before)")


class PhaseClock:
    """Logs what each phase of the run took on the host clock."""

    def __init__(self):
        self.t0 = self.last = time.time()

    def mark(self, phase):
        now = time.time()
        log(f"phase {phase}: {now - self.last:.1f} s "
            f"({now - self.t0:.1f} s since the start)")
        self.last = now


def card_line():
    """nvidia-smi's "name, power.limit" for card 0."""
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def ffrun_lanes(L, B, rng, grid=None):
    """(p1 [L, B], bits [L, B]) whose streams hold the longest carry walks
    a range coder can make.  Every lane keeps the point 0.5 strictly inside
    its interval for as long as it can, by choosing each bin's p1 and bit
    (the cut just beside the point; a byte every two or three bins): its
    stream is 0x7F and then one 0xFF after another.  Lane l does so for
    l / (L - 1) of its bins (lane 0 for none, the last lane to its end),
    then takes the side above the point where one fits: a
    carry that ripples through the whole run, across everything a kernel
    has stored already, into position 0; the bins after it are random.  A
    lane still on the point when its bins end gets that carry from its
    flush.  grid (sorted p1 values): every p1 taken from it, each cut the
    grid's nearest beside the point (the squash table's image, whose steps
    are at most 64 apart)."""
    none = 1 << 40

    def up(x):  # the least grid value >= x, else the largest
        return grid[np.minimum(np.searchsorted(grid, x), len(grid) - 1)]

    def down(x):  # the largest grid value <= x, else the least
        return grid[np.maximum(np.searchsorted(grid, x, "right") - 1, 0)]

    low = np.zeros(L, np.int64)
    rng_ = np.full(L, 0xFFFFFFFF, np.int64)
    point = np.full(L, 1 << 31, np.int64)  # in the coder's shifted coordinates
    held = np.ones(L, bool)  # the lane still holds the point
    cross_at = np.arange(L) * B // max(L - 1, 1)
    p1 = rng.integers(1, 1 << 16, (L, B)).astype(np.int64)
    if grid is not None:
        p1 = up(p1)
    bits = rng.random((L, B)) * 65536 < p1
    for i in range(B):
        at = ((point - low) << 16) // rng_  # the point, in p1's units
        cands = [np.full(L, 0x8000, np.int64), np.clip(at + 2, 1, 0xFFFF),
                 np.clip(at - 2, 1, 0xFFFF)]
        if grid is not None:
            cands = [up(cands[0]), up(cands[1]), down(cands[2])]
        # holding: the narrowest side that still holds the point, but no
        # narrower than 1/512 of the interval
        best = np.full(L, none, np.int64)
        for cand in cands:
            r1 = (rng_ >> 16) * cand
            split = low + r1
            width = np.where((low < point) & (point < split), r1,
                             np.where((split < point) & (point < low + rng_),
                                      rng_ - r1, none))
            take = (held & (i < cross_at) & (width < best)
                    & (width >= rng_ >> 9))
            best = np.where(take, width, best)
            p1[take, i] = cand[take]
            bits[take, i] = (point < split)[take]
        # crossing: the upper side of a cut above the point, where one fits
        r1 = (rng_ >> 16) * cands[1]
        cross = held & (best == none) & (low + r1 > point)
        p1[cross, i] = cands[1][cross]
        bits[cross, i] = False
        held &= ~cross
        # one coder step (the plain version's arithmetic)
        r1 = (rng_ >> 16) * p1[:, i]
        low = np.where(bits[:, i], low, low + r1) & 0xFFFFFFFF
        rng_ = np.where(bits[:, i], r1, rng_ - r1)
        for _ in range(2):
            shift = rng_ < (1 << 24)
            low = np.where(shift, (low << 8) & 0xFFFFFFFF, low)
            rng_ = np.where(shift, (rng_ << 8) & 0xFFFFFFFF, rng_)
            point = np.where(shift & held, 1 << 32, point)
    return p1, bits


def lanes(kind, L, B, seed):
    """Compact lane problem (uint16 p1, int32 bit words, int32 lens) from a
    seed.  lens are ragged: B, 0, 1, B-1, the kernel's tile and 8-bin group
    edges, then random in [0, B].  "zero": random, with p1 = 0 on 1% of the
    bins (no model gives it; the coder's range collapses to 0).  "carry":
    p1 near 0xFFFF with 30% of bins coded against it (pending carries and
    0xFF byte runs).  "ffrun": ffrun_lanes, every lane with all its bins
    (runs of 0xFF as long as the stream, one carry through each).
    "edges": p1 of 1, 2, 0xFFFE or 0xFFFF on half of the bins, random on
    the rest, and every lane ends on a 128-bin tile edge (0 and B among
    them).  "onelong": random, every lane at most one tile long but one in
    each 64 (the index kernel's block), at a place that moves from block
    to block, which has all B bins."""
    rng = np.random.default_rng(seed)
    if kind == "edges":
        p1 = rng.integers(1, 1 << 16, (L, B), dtype=np.int32)
        ends = np.array([1, 2, 0xFFFE, 0xFFFF], np.int32)
        pick = rng.random((L, B), dtype=np.float32) < 0.5
        p1[pick] = ends[rng.integers(0, 4, int(pick.sum()))]
        bits = rng.random((L, B), dtype=np.float32) * 65536 < p1
    elif kind in ("random", "zero", "onelong"):
        p1 = rng.integers(1, 1 << 16, (L, B), dtype=np.int32)
        bits = rng.random((L, B), dtype=np.float32) * 65536 < p1
        if kind == "zero":
            p1[rng.random((L, B), dtype=np.float32) < 0.01] = 0
    elif kind == "ffrun":
        p1, bits = ffrun_lanes(L, B, rng)
    else:
        p1 = rng.integers(0xFFF0, 1 << 16, (L, B), dtype=np.int32)
        bits = rng.random((L, B), dtype=np.float32) > 0.3
    lens = rng.integers(0, B + 1, L).astype(np.int32)
    special = [n for n in (B, 0, 1, B - 1, 127, 128, 129, 7, 8, 9, 31, 32,
                           33, 255, 256, 257) if 0 <= n <= B][:L]
    lens[: len(special)] = special
    if kind == "ffrun":
        lens[:] = B
    if kind == "edges":
        lens = rng.integers(0, B // 128 + 1, L).astype(np.int32) * 128
        lens[:2] = [0, B][:L]
    if kind == "onelong":
        lens = rng.integers(0, min(B, 128) + 1, L).astype(np.int32)
        for b0 in range(0, L, 64):
            lens[b0 + (b0 // 64 * 37) % min(64, L - b0)] = B
    bitw = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    return p1.astype(np.uint16), bitw, lens


def squash_lanes(kind, L, B, seed, cut=None):
    """lanes(kind, L, B, seed) in the index form: (packed uint8
    [L, 3 * B / 2], int32 bit words, int32 lens), every valid bin's p1 on
    the squash table's image and given by its index, padding index 0.
    "random": uniform indices and, where the lanes hold 4,096 valid bins or
    more, every index among them (some p1 values have several); "ffrun"
    builds its runs on the squash grid; every other kind's p1 is moved to
    the nearest squash value, its bits kept.  cut: lens cut to it.  The
    plain form of the problem is unpack_p1_idx's p1 with these bit words
    and lens."""
    sq = tlc._squash_tables()[0]
    grid = np.unique(sq)
    if kind == "ffrun":
        rng = np.random.default_rng(seed)
        p1, bits = ffrun_lanes(L, B, rng, grid)
        bitw = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
        lens = np.full(L, B, np.int32)
    else:
        p1, bitw, lens = lanes(kind, L, B, seed)
        near = np.clip(np.searchsorted(grid, p1), 1, len(grid) - 1)
        lo, hi = grid[near - 1], grid[near]
        p1 = np.where(p1.astype(np.int64) - lo <= hi - p1, lo, hi)
    idx = tlc._squash_tables()[1][p1].astype(np.int64)
    if cut is not None:
        lens = np.minimum(lens, cut)
    live = np.arange(B)[None, :] < lens[:, None]
    if kind == "random":
        rng = np.random.default_rng(seed + 1)
        idx = rng.integers(0, 4096, (L, B))
        pos = np.flatnonzero(live)
        if len(pos) >= 4096:
            idx.flat[pos[:4096]] = rng.permutation(4096)
        bits = rng.random((L, B)) * 65536 < sq[idx]
        bitw = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    return pack_indices(np.where(live, idx, 0)), bitw, lens


def pack_indices(idx):
    """Squash indices [L, B] -> packed uint8 [L, 3 * B / 2], two in three
    bytes, the even bin's in the low 12 bits (pack_p1_idx's layout)."""
    L, B = idx.shape
    pk = np.empty((L, B // 2, 3), np.uint8)
    ev, od = idx[:, 0::2], idx[:, 1::2]
    pk[:, :, 0] = ev & 0xFF
    pk[:, :, 1] = (ev >> 8) | ((od & 0xF) << 4)
    pk[:, :, 2] = od >> 4
    return pk.reshape(L, -1)


def packed_indices(pk):
    """pack_indices' inverse: packed uint8 [L, 3 * B / 2] -> indices [L, B]."""
    b = pk.astype(np.int64).reshape(pk.shape[0], -1, 3)
    ev = b[:, :, 0] | ((b[:, :, 1] & 0xF) << 8)
    od = (b[:, :, 1] >> 4) | (b[:, :, 2] << 4)
    return np.stack([ev, od], axis=-1).reshape(pk.shape[0], -1)


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


def streams_diff(got, ref, M):
    """Largest absolute difference between two (out, nbytes, total) over
    what is specified: total everywhere; nbytes and out[l, :nbytes[l]] on
    the lanes that stayed inside the bound."""
    inside = ref[2] <= M
    err = int((got[2].long() - ref[2].long()).abs().max())
    if bool(inside.any()):
        err = max(err, int((got[1].long() - ref[1].long())[inside].abs().max()))
        idx = torch.arange(M, device=ref[0].device)[None, :]
        live = (idx < ref[1][:, None]) & inside[:, None]
        err = max(err, int(((got[0].long() - ref[0].long()).abs() * live).max()))
    return err


# (kind, L, B, lens cut to, bits_per_byte) of phase 3's fused-kernel cases
STREAM_CASES = [
    ("random", 1, 256, None, 4), ("random", 5, 32, None, 4),
    ("random", 33, 96, None, 4), ("random", 70, 160, None, 4),
    ("random", 31, 4128, None, 4), ("random", 1000, 4096, None, 4),
    ("random", 15, 512, None, 1), ("random", 17, 512, None, 1000),
    ("carry", 1000, 4096, None, 1), ("carry", 1000, 4096, None, 4),
    ("carry", 97, 1184, None, 1), ("carry", 50, 64, None, 1),
    ("carry", 50, 288, 257, 1), ("carry", 40, 4096, None, 1000),
    ("zero", 40, 512, None, 1), ("ffrun", 64, 4096, None, 1),
    ("ffrun", 9, 8192, None, 1), ("ffrun", 33, 2048, None, 4),
    # a block's 32 lanes: one short of a block, one past it, one lane, and
    # one short of the full group; lanes ending on tile edges, p1 at its ends
    ("random", 8191, 256, None, 4), ("edges", 1, 4096, None, 4),
    ("edges", 31, 4096, None, 4), ("edges", 33, 1024, None, 1),
    # the index kernel's blocks: one lane group a block while the groups fit
    # one an SM (4,224 lanes on 132 SMs), else two (64 lanes): counts about
    # 64 and 128 on the first shape; the last count of the first, the first
    # of the second (a block with one lane, its second group empty), one
    # short of 68 blocks (its last group 31 lanes), one past the full group;
    # one long lane in every 64 among short ones, on both shapes
    ("random", 63, 256, None, 4), ("random", 64, 288, None, 4),
    ("random", 65, 160, None, 4), ("random", 127, 128, None, 1),
    ("random", 129, 256, None, 4), ("random", 4224, 128, None, 4),
    ("random", 4225, 128, None, 1), ("random", 4351, 160, None, 4),
    ("random", 8193, 128, None, 4), ("onelong", 200, 4096, None, 4),
    ("onelong", 129, 2048, None, 1), ("onelong", 4300, 512, None, 4),
]
LONE_LANE = 32768  # bins of the longest lane the lane coders take (MAX_B)
LONE_UNIT = 64096  # bins of the longest pinned v1 unit (mbaff_b.mkv, gop)


def phase_streams_vs_plain(dev, cases):
    """lane_encode_streams vs lane_encode_streams_plain on the same card
    tensors, and vs finalize_lanes (host) of lane_encode's tokens; returns
    the largest absolute difference seen (must be 0)."""
    worst = 0
    made = None  # the last problem, for the next case on the same lanes
    for kind, L, B, cut, bpb in cases:
        if made is None or made[0] != (kind, L, B, cut):
            p1u16, bitw, lens = lanes(kind, L, B, seed=L + B)
            if cut is not None:
                lens = np.minimum(lens, cut)
            prob = tlc.from_numpy_problem(p1u16, bitw, lens, dev)
            host = tlc.finalize_lanes(
                *(t.cpu().numpy() for t in tlc.lane_encode(*prob)), lens)
            made = ((kind, L, B, cut), prob, lens, host)
        _, prob, lens, host = made
        M = tlc.max_bytes(B, bpb)
        got = tlc.lane_encode_streams(*prob, M)
        torch.cuda.synchronize(dev)
        ref = tlc.lane_encode_streams_plain(*prob, M)
        err = streams_diff(got, ref, M)
        worst = max(worst, err)
        out, nb, tot = (t.cpu().numpy() for t in got)
        inside = tot <= M
        host_ok = all(bytes(out[l, : nb[l]]) == host[l]
                      for l in range(L) if inside[l])
        walked = sum(s[:1] == b"\x80" and not any(s[1:33])
                     for s in host) if kind == "ffrun" else 0
        log(f"streams kernel vs plain {kind} L={L} B={B} lens<={cut or B} "
            f"bits_per_byte={bpb} (M={M}): max_abs_err={err} lanes inside "
            f"the bound {int(inside.sum())}/{L}, equal to the host finalize: "
            f"{host_ok}, stream bytes {int(nb[inside].sum())}, longest "
            f"{int(tot.max())}"
            + (f", lanes with a carry walked to position 0: {walked}"
               if kind == "ffrun" else ""))
        if err or not host_ok:
            raise AssertionError(f"fused kernel != plain for {kind} L={L} "
                                 f"B={B} bits_per_byte={bpb}")
        if kind == "ffrun" and bpb == 1 and (walked < 2 or not inside.all()):
            raise AssertionError("the 0xFF-run case made no long carry walk")
    return worst


def lone_lane_vs_host(dev, n, seed, index=False):
    """One random lane of n bins through lane_encode_streams (index: its p1
    uniform squash indices, through lane_encode_streams_idx), held to the
    host RangeEncoder (the plain loop over n bin steps is slow); returns
    the largest absolute difference of the bytes and the length (must be
    0)."""
    rng = np.random.default_rng(seed)
    if index:
        idx = rng.integers(0, 4096, (1, n))
        p1 = tlc._squash_tables()[0][idx].astype(np.uint16)
    else:
        p1 = rng.integers(1, 1 << 16, (1, n)).astype(np.uint16)
    bits = rng.random((1, n)) * 65536 < p1
    bitw = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    enc = RangeEncoder()
    for b, p in zip(bits[0].tolist(), p1[0].tolist()):
        enc.put(int(b), p)
    want = np.frombuffer(bytes(enc.finish()), np.uint8)
    M = tlc.max_bytes(n, 1)
    prob = tlc.from_numpy_problem(pack_indices(idx) if index else p1, bitw,
                                  np.array([n], np.int32), dev)
    code = tlc.lane_encode_streams_idx if index else tlc.lane_encode_streams
    out, nb, tot = (t.cpu().numpy() for t in code(*prob, M))
    err = abs(int(nb[0]) - len(want))
    if not err:
        err = int(np.abs(out[0, :nb[0]].astype(np.int64) - want).max(initial=0))
    log(f"streams kernel{' (index form)' if index else ''} vs host encoder, "
        f"one lane of {n} bins: max_abs_err={err}, {len(want)} bytes, "
        f"total {int(tot[0])}")
    if err:
        raise AssertionError(f"fused kernel != host encoder on one lane of "
                             f"{n} bins")
    return err


def phase_streams_idx_vs_plain(dev, cases):
    """lane_encode_streams_idx vs lane_encode_streams_idx_plain on the same
    card tensors, and vs lane_encode_streams on the same lanes in the u16
    form; the cases' p1 on the squash image (squash_lanes: every index where
    the lanes hold 4,096 valid bins, padding index 0).  Then unpack_p1_idx
    vs unpack_p1_idx_plain on each problem.  Returns the largest absolute
    differences (streams, unpack; both must be 0)."""
    worst = worst_unpack = 0
    made = None
    for kind, L, B, cut, bpb in cases:
        if made is None or made[0] != (kind, L, B, cut):
            pk, bitw, lens = squash_lanes(kind, L, B, seed=L + B, cut=cut)
            prob = tlc.from_numpy_problem(pk, bitw, lens, dev)
            p1 = tlc.unpack_p1_idx(prob[0])
            torch.cuda.synchronize(dev)
            u_err = max_abs_diff([p1], [tlc.unpack_p1_idx_plain(prob[0])])
            worst_unpack = max(worst_unpack, u_err)
            live = np.arange(B)[None, :] < lens[:, None]
            n_idx = len(np.unique(packed_indices(pk)[live]))
            log(f"unpack_p1_idx vs plain {kind} L={L} B={B}: "
                f"max_abs_err={u_err}, {n_idx} distinct indices in the "
                f"valid bins")
            if u_err:
                raise AssertionError(f"unpack kernel != plain for {kind} "
                                     f"L={L} B={B}")
            made = ((kind, L, B, cut), prob, p1)
        _, prob, p1 = made
        M = tlc.max_bytes(B, bpb)
        got = tlc.lane_encode_streams_idx(*prob, M)
        u16 = tlc.lane_encode_streams(p1, prob[1], prob[2], M)
        torch.cuda.synchronize(dev)
        ref = tlc.lane_encode_streams_idx_plain(*prob, M)
        err = max(streams_diff(got, ref, M), streams_diff(got, u16, M))
        worst = max(worst, err)
        tot = got[2].cpu().numpy()
        log(f"streams index kernel vs plain and vs the u16 kernel {kind} "
            f"L={L} B={B} lens<={cut or B} bits_per_byte={bpb} (M={M}): "
            f"max_abs_err={err}, lanes inside the bound "
            f"{int((tot <= M).sum())}/{L}, longest {int(tot.max())}")
        if err:
            raise AssertionError(f"index kernel != plain for {kind} L={L} "
                                 f"B={B} bits_per_byte={bpb}")
    return worst, worst_unpack


def phase_zero_p1(dev):
    """A valid bin with p1 = 0 takes the u16 form: the squash-image rule
    (choose_form) refuses the index form, lane_streams_device_compact
    launches lane_encode_streams and not the index kernel, and the lane
    codes p1 = 0 as the plain coder does.  Returns the u16 launches."""
    pk, bitw, lens = squash_lanes("random", 40, 512, seed=3)
    p1 = tlc.unpack_p1_idx_plain(torch.from_numpy(pk)).numpy()
    p1[np.arange(512)[None, :] >= lens[:, None]] = 0
    p1[0, 10] = 0  # lens[0] is B
    chosen = tlc.choose_form(p1, lens)
    fused, idx = tlc.lane_encode_streams.launches, \
        tlc.lane_encode_streams_idx.launches
    got = tlc.lane_streams_device_compact(chosen, bitw, lens, dev)
    fused = tlc.lane_encode_streams.launches - fused
    idx = tlc.lane_encode_streams_idx.launches - idx
    prob = tlc.from_numpy_problem(p1, bitw, lens, dev)
    ref = tlc.finalize_lanes(*(t.cpu().numpy()
                               for t in tlc.lane_encode_plain(*prob)), lens)
    log(f"a valid p1 = 0: form {chosen.dtype}, lane_encode_streams launches "
        f"{fused}, lane_encode_streams_idx launches {idx}, streams equal to "
        f"the plain coder's: {got == ref}")
    if chosen.dtype != np.uint16 or (fused, idx) != (1, 0) or got != ref:
        raise AssertionError("a valid p1 = 0 did not take the u16 form")
    return fused


def phase_overflow(dev, L, B):
    """Dense streams past the byte bound, in both upload forms: the group
    is coded again with lane_encode (an index-form group's p1 unpacked on
    the card first) and finalized exactly on the host.  Returns the
    launches in those calls: {kernel name: count}."""
    counts = {}
    for index in (False, True):
        if index:
            p1, bitw, lens = squash_lanes("carry", L, B, seed=7)
        else:
            p1, bitw, lens = lanes("random", L, B, seed=7)
        before = tlc.lane_collect.overflows
        kernels = {"lane_encode_streams_idx" if index
                   else "lane_encode_streams": None, "lane_encode": None}
        if index:
            kernels["unpack_p1_idx"] = None
        for name in kernels:
            kernels[name] = getattr(tlc, name).launches
        got = tlc.lane_streams_device_compact(p1, bitw, lens, dev,
                                              bits_per_byte=1000)
        for name in kernels:
            kernels[name] = getattr(tlc, name).launches - kernels[name]
            counts[name] = counts.get(name, 0) + kernels[name]
        prob = tlc.from_numpy_problem(p1, bitw, lens, dev)
        if index:
            prob = (tlc.unpack_p1_idx_plain(prob[0]), *prob[1:])
        ref = tlc.finalize_lanes(*(t.cpu().numpy()
                                   for t in tlc.lane_encode_plain(*prob)),
                                 lens)
        log(f"overflow finalize, {'index' if index else 'u16'} form: "
            f"lane_collect.overflows={tlc.lane_collect.overflows} (was "
            f"{before}), launches {kernels}")
        if (tlc.lane_collect.overflows != before + 1 or got != ref
                or set(kernels.values()) != {1}):
            raise AssertionError("overflow-finalize path did not match")
    return counts


LANE_KERNELS = ("lane_encode", "lane_encode_streams", "lane_encode_streams_idx",
                "unpack_p1_idx")


def _zero_counts():
    """Set the launch counts of the lane kernels' wrappers to 0."""
    for name in LANE_KERNELS:
        getattr(tlc, name).launches = 0


def phase_off_image(dev):
    """lane_streams_device_compact on random lanes, whose p1 leave the
    squash image: the rule (choose_form) keeps the u16 form, which launches
    lane_encode_streams, equal to the host finalize.  Returns its
    launches."""
    p1u16, bitw, lens = lanes("random", 1000, 4096, seed=8)
    chosen = tlc.choose_form(p1u16, lens)
    got = tlc.lane_streams_device_compact(chosen, bitw, lens, dev)
    fused = tlc.lane_encode_streams.launches
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, dev)
    ref = tlc.finalize_lanes(*(t.cpu().numpy()
                               for t in tlc.lane_encode(*prob)), lens)
    log(f"p1 off the squash image: form {chosen.dtype}, lane_encode_streams "
        f"launches {fused}, lane_encode_streams_idx launches "
        f"{tlc.lane_encode_streams_idx.launches}, streams equal to the host "
        f"finalize: {got == ref}")
    if (chosen.dtype != np.uint16 or fused != 1 or got != ref
            or tlc.lane_encode_streams_idx.launches):
        raise AssertionError("p1 off the squash image did not take the u16 "
                             "form")
    return fused


def assert_native_extractor(clip, data, scope, want_slots):
    """The host stage of device_compress must be the C++ extractor: its
    Python fallback gives the same traces, so only this shows a library
    that failed to build or to parse."""
    stats = extract_traces(data, scope=scope, want_slots=want_slots)[4]
    if stats["native"] is not True:
        raise AssertionError(f"{clip} {scope}: the native extractor did not "
                             f"run (stats={stats})")


def phase_main_path(dev, Bs, clips):
    """The port's main path on real clips, held to the host codec.  Returns
    ({(clip, B): the container, equal to codec.compress}, launches of
    lane_encode_streams_idx by entry point)."""
    datas = [open(os.path.join(ROOT, "data", c), "rb").read() for c in clips]
    for clip, data in zip(clips, datas):
        assert_native_extractor(clip, data, "gop", want_slots=False)
    containers = {}
    launches = {"device_compress": 0, "device_compress_corpus": 0}
    for B in Bs:
        per_file = []
        for clip, data in zip(clips, datas):
            t0 = time.time()
            before = tlc.lane_encode_streams_idx.launches
            out = device_compress(data, scope="gop", substream_bins=B,
                                  device=dev)
            launches["device_compress"] += (
                tlc.lane_encode_streams_idx.launches - before)
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
            containers[clip, B] = out
        stats = {}
        t0 = time.time()
        before = tlc.lane_encode_streams_idx.launches
        outs = device_compress_corpus(datas, scope="gop", substream_bins=B,
                                      device=dev, stats=stats)
        launches["device_compress_corpus"] += (
            tlc.lane_encode_streams_idx.launches - before)
        dt = time.time() - t0
        if outs != per_file:
            raise AssertionError(f"B={B}: corpus != per-file containers")
        log(f"corpus B={B}: {len(outs)} containers equal per-file, "
            f"{stats['bins']} bins, {stats['dispatches']} dispatches, "
            f"{dt:.3f} s = {len(outs) / dt:.2f} containers/s, "
            f"{stats['bins'] / dt:.4g} bins/s (host clock)")
    return containers, launches


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


def tiled_trace(clips, L, B):
    """One native trace of L * B records tiled from the clips' real
    records, in the order in which tiled_problem tiles their (bit, p1): the
    lane packers cut it into tiled_problem's [L, B] lanes."""
    recs = []
    for c in clips:
        data = open(os.path.join(ROOT, "data", c), "rb").read()
        recs += [t.recs.copy()
                 for t in native.extract(data, "gop", want_slots=False)[3]]
    r = np.concatenate(recs)
    r = np.tile(r, -(-(L * B) // len(r)))[: L * B]
    return native.NativeTrace(r, np.zeros(0, np.int32))


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


def lane_ops(per, n_bins, n_steps):
    """Integer operations of a lane algorithm (LANE_OPS, STREAM_OPS,
    DECODE_OPS) over n_bins bins and n_steps renorm steps."""
    return per[0] * n_bins + per[1] * n_steps


def bound_terms(n_bytes, n_ops):
    """Both terms of bound_ms, for the log."""
    return (f"{n_bytes} bytes = {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
            f"{n_ops} operations = {n_ops / INT_OPS_PER_S * 1e3:.4f} ms")


def lane_stage_split(dev, p1u16, bitw, lens, runs=3):
    """lane_streams_device_compact on one group (p1 in either upload form)
    stage by stage, the device idle between stages (a synchronize after
    each): ({stage: least ms over the runs}, the streams)."""
    M = tlc.max_bytes(tlc.lane_bins(p1u16))
    n = p1u16.shape[0]
    best = {}

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        best[name] = min(ms, best.get(name, ms))
        return res

    code = (tlc.lane_encode_streams_idx if tlc.index_form(p1u16)
            else tlc.lane_encode_streams)
    for _ in range(runs):
        prob = timed("upload", lambda: tuple(
            tlc._upload(a, dev) for a in (p1u16, bitw, lens)))
        got = timed("kernel", lambda: code(*prob, M))
        back = timed("read-back", lambda: tlc.read_group(n, *got))
        streams = timed("slicing", lambda: tlc.cut_streams(*back))
    return best, streams


def phase_full_dispatch(dev, clips, L, B, card):
    p1u16, bitw, lens = tiled_problem(clips, L, B)
    # the index form of the same lanes, from the same records, through the
    # main path's packer
    trace = tiled_trace(clips, L, B)
    t0 = time.perf_counter()
    p1pk, bitw_i, lens_i, _ = tlc.pack_lanes([trace], B)
    t_pack = (time.perf_counter() - t0) * 1e3
    del trace
    if (p1pk.dtype != np.uint8 or not np.array_equal(bitw_i, bitw)
            or not np.array_equal(lens_i, lens)):
        raise AssertionError("full dispatch: the native packer's index form "
                             "differs from the tiled lanes")
    del bitw_i, lens_i
    M = tlc.max_bytes(B)
    e2e = {"u16": [], "index": []}
    for form, p1 in (("u16", p1u16), ("index", p1pk)):
        for _ in range(3):  # the first call allocates the pinned buffers
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            got_streams = tlc.lane_streams_device_compact(p1, bitw, lens, dev)
            e2e[form].append((time.perf_counter() - t0) * 1e3)
        if form == "u16":
            streams = got_streams
        elif got_streams != streams:
            raise AssertionError("full dispatch: the index form's streams "
                                 "differ from the u16 form's")
    del got_streams
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, dev)
    iprob = tlc.from_numpy_problem(p1pk, bitw, lens, dev)
    unpacked = tlc.unpack_p1_idx(iprob[0])
    un_plain = tlc.unpack_p1_idx_plain(iprob[0])
    u_err = max_abs_diff([unpacked], [un_plain])
    if u_err or not torch.equal(unpacked, prob[0]):
        raise AssertionError("full dispatch: unpack_p1_idx != plain, or the "
                             "unpacked p1 != the u16 form's")
    del unpacked, un_plain
    u1 = cuda_ms(lambda: tlc.unpack_p1_idx(iprob[0]), 5)
    u_plain = cuda_ms(lambda: tlc.unpack_p1_idx_plain(iprob[0]), 1)
    u2 = cuda_ms(lambda: tlc.unpack_p1_idx(iprob[0]), 5)
    tlc.lane_encode(*prob)  # warm-up
    tlc.lane_encode_streams(*prob, M)
    tlc.lane_encode_streams_idx(*iprob, M)
    k1 = cuda_ms(lambda: tlc.lane_encode(*prob), 5)
    s1 = cuda_ms(lambda: tlc.lane_encode_streams(*prob, M), 5)
    i1 = cuda_ms(lambda: tlc.lane_encode_streams_idx(*iprob, M), 5)
    ref = []
    plain = cuda_ms(lambda: ref.append(tlc.lane_encode_plain(*prob)), 1)
    raw = ref.pop()
    plain_fin = cuda_ms(lambda: ref.append(tlc.finalize_device(*raw, M)), 1)
    i2 = cuda_ms(lambda: tlc.lane_encode_streams_idx(*iprob, M), 5)
    s2 = cuda_ms(lambda: tlc.lane_encode_streams(*prob, M), 5)
    k2 = cuda_ms(lambda: tlc.lane_encode(*prob), 5)
    got = tlc.lane_encode(*prob)
    err = max_abs_diff(got, raw)
    if err or not all(torch.equal(a, b) for a, b in zip(got, raw)):
        raise AssertionError("full dispatch: kernel tokens != plain tokens")
    ref_out, ref_nb, overflow = ref.pop()
    ref_tot = ((raw[0] >> 16) & 3).sum(dim=1, dtype=torch.int32) + 2
    del raw, got
    fused = tlc.lane_encode_streams(*prob, M)
    s_err = streams_diff(fused, (ref_out, ref_nb, ref_tot), M)
    plain_streams = tlc.cut_streams(*tlc.read_group(L, ref_out, ref_nb,
                                                    ref_tot))
    if s_err or bool(overflow) or streams != plain_streams:
        raise AssertionError("full dispatch: fused kernel streams != plain")
    # the index form's plain version is unpack_p1_idx_plain, then the u16
    # form's plain version: its p1 equal prob[0] (checked above), so its
    # streams are the u16 plain streams
    fused_i = tlc.lane_encode_streams_idx(*iprob, M)
    i_err = streams_diff(fused_i, (ref_out, ref_nb, ref_tot), M)
    if i_err:
        raise AssertionError("full dispatch: index kernel streams != plain")
    nbytes = sum(map(len, streams))
    emitted = int(ref_tot.sum())
    del ref_out, fused, fused_i
    log(f"full dispatch [{L}, {B}]: lane_encode = plain (tokens), "
        f"lane_encode_streams = plain (streams), lane_encode_streams_idx = "
        f"plain (streams), unpack_p1_idx = plain and = the u16 form's p1, "
        f"{L * B} bins -> {nbytes} bytes; native packer, index form, "
        f"{t_pack:.1f} ms; lane_streams_device_compact on the host clock, "
        f"three calls in a row (the first allocates the pinned buffers): "
        + "; ".join(f"{form} form {', '.join(f'{t:.1f}' for t in ts)} ms = "
                    f"{L * B / (min(ts) / 1e3):.4g} bins/s"
                    for form, ts in e2e.items()))
    ms = (k1 + k2) / 2
    # p1 and bit words in, tok and car out, lens/ftok/fcar a lane
    n_bytes = L * B * 2 + L * B // 8 + 2 * L * B * 4 + 3 * L * 4
    # the bins the lanes hold, and a renorm step for each emitted byte (the
    # two flush bytes included)
    n_bins = int(np.minimum(lens, B).sum())
    n_ops = lane_ops(LANE_OPS, n_bins, emitted)
    bound, by = bound_ms(n_bytes, n_ops)
    log(f"full dispatch timing [{L}, {B}] on {card}: lane_encode {k1:.3f} / "
        f"{k2:.3f} ms (mean {ms:.3f} ms), plain {plain:.1f} ms, kernel "
        f"{L * B / (ms / 1e3):.4g} bins/s; bound {bound:.3f} ms by {by} "
        f"({bound_terms(n_bytes, n_ops)}), the kernel is at {bound / ms:.1%} "
        f"of it")
    chain = B * DECODE_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3
    # p1 (or packed indices and the table), bit words and lens in; the bytes
    # this data emits, nbytes and total out
    rest = L * B // 8 + L * 4 + emitted + 2 * L * 4
    forms = {}
    for form, t1, t2, p1_bytes, ops, p_ms in (
            ("u16", s1, s2, L * B * 2, STREAM_OPS, plain + plain_fin),
            ("index", i1, i2, L * B * 3 // 2 + 4096 * 2, STREAM_IDX_OPS,
             u_plain + plain + plain_fin)):
        f_ms = (t1 + t2) / 2
        f_bytes = p1_bytes + rest
        f_ops = lane_ops(ops, n_bins, emitted)
        f_bound, f_by = bound_ms(f_bytes, f_ops)
        name = ("lane_encode_streams_idx" if form == "index"
                else "lane_encode_streams")
        log(f"full dispatch timing [{L}, {B}] on {card}: {name} "
            f"{t1:.3f} / {t2:.3f} ms (mean {f_ms:.3f} ms, "
            f"{L * B / (f_ms / 1e3):.4g} bins/s), plain {p_ms:.1f} ms "
            + (f"(unpack {u_plain:.1f} + " if form == "index" else "(")
            + f"encode {plain:.1f} + finalize {plain_fin:.1f}); bound "
            f"{f_bound:.3f} ms by {f_by} ({bound_terms(f_bytes, f_ops)}; "
            f"{emitted} bytes emitted), the kernel is at {f_bound / f_ms:.1%} "
            f"of it; a lane's chain floor ({B} bins x "
            f"{DECODE_CHAIN_CYCLES} cycles) {chain:.3f} ms, the kernel is at "
            f"{chain / f_ms:.1%} of that")
        forms[form] = (f_ms, p_ms, f_bound, f_by)
    u_ms = (u1 + u2) / 2
    # packed indices and the table in, p1 out; a field's shift and mask and
    # its lookup a bin
    u_bytes = L * B * 3 // 2 + 4096 * 2 + L * B * 2
    u_bound, u_by = bound_ms(u_bytes, UNPACK_OPS * L * B)
    log(f"full dispatch timing [{L}, {B}] on {card}: unpack_p1_idx {u1:.3f} "
        f"/ {u2:.3f} ms (mean {u_ms:.3f} ms), plain {u_plain:.1f} ms; bound "
        f"{u_bound:.3f} ms by {u_by} "
        f"({bound_terms(u_bytes, UNPACK_OPS * L * B)}), the kernel is at "
        f"{u_bound / u_ms:.1%} of it; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del prob, iprob
    for form, p1 in (("u16", p1u16), ("index", p1pk)):
        split, staged = lane_stage_split(dev, p1, bitw, lens)
        if staged != streams:
            raise AssertionError("full dispatch: the staged streams differ")
        log(f"full dispatch stages [{L}, {B}], {form} form, on {card}, ms, "
            f"least of 3, the device idle between stages: "
            + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + f", sum {sum(split.values()):.2f}")
    lane = (err, ms, plain, bound, by)
    fused = (s_err, *forms["u16"])
    fused_idx = (i_err, *forms["index"])
    unpack = (u_err, u_ms, u_plain, u_bound, u_by)
    return lane, fused, fused_idx, unpack, (streams, p1u16, bitw, lens)


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
    limit and halve; "runs": runs of 1-70 bins, each one slot repeated, or
    distinct slots of one class (slots 16k to 16k + 15 share a class), or
    random slots, so that consecutive bins share a slot, a class or both
    across tile edges and ring wraps.  Row 0 has a ragged tail, and every
    third pcab is 0 (no CABAC input)."""
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
    elif kind == "runs":
        cls = (np.arange(NS)[None, :] // 16 % tec.N_CLS).repeat(S, 0)
        for s in range(S):
            i = 0
            while i < T:
                n = int(rng.integers(1, 71))
                way = rng.integers(0, 3)
                if way == 0:  # one slot: its row and its class repeat
                    slots[s, i: i + n] = rng.integers(0, NS)
                elif way == 1:  # distinct slots of one class
                    base = int(rng.integers(0, -(-NS // 16))) * 16
                    slots[s, i: i + n] = np.minimum(
                        base + np.arange(n)[: T - i] % 16, NS - 1)
                i += n
    elif kind == "sweep":
        slots[:] = 0
        slots[:, ::50] = NS - 1
        bits = rng.random((S, T), dtype=np.float32) < 0.995
        limits[:, 0] = [SWEEP_LIMITS[s % len(SWEEP_LIMITS)] for s in range(S)]
    return slots, bits, pcabs, limits, valid, cls


# (kind, S, T, NS): the cases of the first est kernel, then what stage
# warps over 32-bin tiles and rings of RING_TILES tiles can get wrong.
# est_launch_plan puts 6, 5, 3, 4, 3 and 6 traces in a block at NS = 64,
# 512, 4096, 2108, 3494 and 30000, keeps the rows in global scratch at
# 30000, and in shared memory up to EST_ROWS_SHARED_NS (the two sides of
# that budget: tests/test_torch_kernel_host.py holds the plan to them).
EST_ROWS_SHARED_NS = 22442
EST_CASES = [
    ("random", 64, 4096, 1024), ("skew", 64, 2048, 64),
    ("holes", 64, 2048, 512), ("random", 16, 2048, 4096),
    ("random", 3, 1000, 2108), ("random", 5, 517, 3494),
    ("random", 9, 777, 30000), ("holes", 10, 300, 30000),
    ("random", 4, 1, 8), ("random", 4, 5, 8), ("random", 4, 31, 8),
    ("random", 4, 33, 8), ("tail", 40, 250, 32), ("oneslot", 8, 1500, 8),
    ("oneslot", 3, 700, 30000),
    # slot and class runs across tile edges and ring wraps, 128 tiles a
    # trace, several traces a block with a part-filled last block, and
    # both sides of the rows' shared-memory budget
    ("runs", 5, 4101, 256), ("runs", 13, 3000, 64),
    ("runs", 3, 700, EST_ROWS_SHARED_NS),
    ("runs", 3, 700, EST_ROWS_SHARED_NS + 1),
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
        traces, rows_shared, smem = tec.est_launch_plan(NS)
        log(f"est kernel vs plain {kind} S={S} T={T} NS={NS} ({traces} "
            f"traces of {tec.STAGE_WARPS} stage warps a block, rows in "
            f"{'shared' if rows_shared else 'global'} "
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


def est_kernel_only_ms(prob, reps, waits=None):
    """The est kernel's own time on a checked problem (no range check, no
    zero fill), and the zero fill's, by CUDA events; the warm-up launch
    fills `waits` (est_coder._launch) where it is given."""
    S, T = prob[0].shape
    tok = torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=prob[0].device)
    car = torch.zeros_like(tok)
    count = torch.zeros(S, dtype=torch.int32, device=tok.device)
    tec._launch(*prob, tok, car, count, waits)  # warm-up
    kernel = cuda_ms(lambda: tec._launch(*prob, tok, car, count), reps)
    fill = cuda_ms(lambda: (tok.zero_(), car.zero_()), reps)
    return kernel, fill


def stage_waits(waits, T):
    """One line of a launch's stage waits (est_coder._launch's int32 [S,
    STAGE_WARPS]): per stage the tiles summed over the traces and their
    share of the tiles the traces handed on (at most T / 32 each)."""
    w = waits.sum(0).tolist()
    tiles = waits.shape[0] * -(-T // 32)
    names = ("rows (ring to the mixer full)", "mixer (input empty)",
             "APM (input empty)", "coder (input empty)")
    return "; ".join(f"{n} {k} tiles, {k / tiles:.1%}"
                     for n, k in zip(names, w))


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
    # the plain version once on the distinct base traces, padded alike
    # (rows are independent): row r of the problem is base row r % len(base)
    base_prob = tec.from_numpy_traces(
        *tec.pack_rows(base, len(base), T, NS), dev)
    ref = []
    plain = cuda_ms(lambda: ref.append(tec.est_encode_plain(*base_prob)), 1)
    k2 = cuda_ms(lambda: tec.est_encode(*prob), 3)
    rows = torch.arange(S, device=dev) % len(base)
    want = [x[rows] for x in ref[0]]
    err = max_abs_diff(got, want)
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("est full size: kernel tokens != plain tokens")
    if streams != tec.finalize_streams(*(t.cpu() for t in want)):
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
        f"{plain:.1f} ms on the {len(base)} distinct base traces, which every "
        f"kernel row equals; bound "
        f"{bound:.3f} ms by {by} ({n_bytes} bytes, {n_tokens} tokens), "
        f"est_encode is at {bound / ms:.1%} of it")
    del got, ref, want, prob, base_prob

    data = open(os.path.join(ROOT, "data", "mbaff_b.mkv"), "rb").read()
    longest = max(native.extract(data, "gop", want_slots=True)[3], key=len)
    prob = tec.from_numpy_traces(
        *tec.pack_rows([longest], 1, len(longest), len(longest.limits)), dev)
    waits = torch.zeros((1, tec.STAGE_WARPS), dtype=torch.int32, device=dev)
    one, _ = est_kernel_only_ms(prob, 3, waits)
    log(f"est longest gop trace (mbaff_b.mkv, {len(longest)} bins, one "
        f"trace) on {card}: kernel alone {one:.3f} ms = "
        f"{one * 1e3 / len(longest):.3f} us/bin; waits: "
        f"{stage_waits(waits, len(longest))}")

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


def archive_group(S=ARCHIVE_S):
    """The archive cell's est group: the benchmark's four camera GOPs
    extracted at gop scope (native traces with slot tables), repeated to S
    GOP-long traces: 48 by default, the cell's longest recording, which
    the est stage codes as one group on the card (est_coder.card_group_bins
    budgets a group by the card's free memory)."""
    traces = []
    for i in range(1, 5):
        path = os.path.join(ROOT, "benchmark", "clips", "camera",
                            f"cam_gop{i}.264")
        with open(path, "rb") as f:
            traces += native.extract(f.read(), "gop", want_slots=True)[3]
    return [traces[i % len(traces)] for i in range(S)]


def archive_problem(dev, group):
    """The est problem of a group of traces (archive_group) on `dev`, its
    rows unpacked on the card from the records as the est path does."""
    S, T = len(group), max(map(len, group))
    NS = max(len(t.limits) for t in group)
    slots, bits, pcabs, valid = tec.est_unpack(
        [tec._upload(tec.trace_records(t), dev) for t in group], S, T)
    limits, cls = (tec._upload(a, dev) for a in tec.slot_tables(group, S, NS))
    return slots, bits, pcabs, limits, valid, cls


def phase_est_archive(dev, card, group):
    """The est kernel on the archive cell's group (archive_group,
    archive_problem): the kernel alone by CUDA events, and its stage
    waits -> ms."""
    prob = archive_problem(dev, group)
    S, T = prob[0].shape
    NS = prob[3].shape[1]
    waits = torch.zeros((S, tec.STAGE_WARPS), dtype=torch.int32, device=dev)
    ms, _ = est_kernel_only_ms(prob, 2, waits)
    traces, rows_shared, smem = tec.est_launch_plan(NS)
    log(f"est archive group [{S}, {T}] ({sum(map(len, group))} bins, NS="
        f"{NS}; {traces} traces a block, rows in "
        f"{'shared' if rows_shared else 'global'} memory, {smem} B) on "
        f"{card}: kernel alone {ms:.3f} ms = {ms * 1e3 / T:.4f} us per bin "
        f"step; waits: {stage_waits(waits, T)}")
    return ms


def phase_est_unpack(dev, card):
    """est_unpack on the archive cell's group against pack_rows' rows and
    est_unpack_plain, exactly; the kernel's launch alone, its pointer
    table and rows made before, timed with CUDA events -> (err, ms, plain
    ms, bound ms, bound by)."""
    group = archive_group()
    S, T = len(group), max(map(len, group))
    NS = max(len(t.limits) for t in group)
    n_bins = sum(map(len, group))
    recs = [tec._upload(tec.trace_records(t), dev) for t in group]
    got = tec.est_unpack(recs, S, T)
    packed = tec.from_numpy_traces(*tec.pack_rows(group, S, T, NS), dev)
    want = (packed[0], packed[1], packed[2], packed[4])
    ref = []
    plain = cuda_ms(lambda: ref.append(tec.est_unpack_plain(recs, S, T)), 1)
    err = max(max_abs_diff(got, want), max_abs_diff(got, ref[0]))
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)) or \
            not all(torch.equal(a, b) for a, b in zip(got, ref[0])):
        raise AssertionError("est_unpack: rows != pack_rows' or plain rows")
    del packed, want, ref
    table = tec.record_table(recs)
    ms = cuda_ms(lambda: tec._unpack_launch(table, S, got), 10)
    # each valid bin's record read once, the four rows written once, the
    # pointer table; three masks and shifts a padded bin
    n_bytes = 8 * n_bins + 16 * S * T + 16 * S
    bound, by = bound_ms(n_bytes, 3 * S * T)
    log(f"est_unpack archive group [{S}, {T}] ({n_bins} bins, NS={NS}) on "
        f"{card}: kernel {ms:.3f} ms, plain {plain:.1f} ms, rows equal to "
        f"pack_rows' and the plain version's; bound {bound:.3f} ms by {by} "
        f"({n_bytes} bytes), est_unpack is at {bound / ms:.1%} of it")
    return err, ms, plain, bound, by


def decode_problem(kind, L, B, seed, dev):
    """(decode problem on the card, bits that must come out or None).
    "bytes": random stream bytes, sizes 0, 1, 2, 3 first, then random up to
    B / 2; p1 with 0 and 0xFFFF among them; nothing to invert.  Any other
    kind: lanes(kind, ...) encoded on the card by lane_encode and the
    device finalize.  The bin axis keeps its width B (a multiple of 32),
    so widths off the kernel's 128-bin tile reach the kernel."""
    if kind == "bytes":
        rng = np.random.default_rng(seed)
        sizes = rng.integers(0, B // 2 + 1, L)
        sizes[:4] = [0, 1, 2, 3][:L]
        streams = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                   for n in sizes]
        p1u16 = rng.integers(0, 1 << 16, (L, B)).astype(np.uint16)
        p1u16[rng.random((L, B), dtype=np.float32) < 0.01] = 0
        p1u16[rng.random((L, B), dtype=np.float32) < 0.01] = 0xFFFF
        lens = rng.integers(0, B + 1, L).astype(np.int32)
        lens[:3] = [B, B - 1, 0][:L]
        want = None
    else:
        p1u16, bitw, lens = lanes(kind, L, B, seed)
        streams = tlc.lane_streams_device_compact(p1u16, bitw, lens, dev)
        live = np.arange(B)[None, :] < lens[:, None]
        # p1 = 0 collapses the encoder's range: its streams do not invert
        want = None if kind == "zero" else tld.unpack_bits(bitw) * live
    prob = tld.from_numpy_problem(*tld.pack_streams(streams), p1u16, lens, dev)
    return prob, want


def one_long_lane(n, seed, dev):
    """One lane of n bins from the host RangeEncoder (the lane encoder
    stops at 32,768 bins a lane)."""
    rng = np.random.default_rng(seed)
    p1 = rng.integers(1, 1 << 16, n)
    bits = (rng.random(n) * 65536 < p1).astype(np.uint8)
    enc = RangeEncoder()
    for b, p in zip(bits.tolist(), p1.tolist()):
        enc.put(b, p)
    prob = tld.pack_decode_problem([bytes(enc.finish())], p1[None, :], [n])
    want = np.zeros((1, prob[2].shape[1]), np.uint8)
    want[0, :n] = bits
    return tld.from_numpy_problem(*prob, dev), want


def check_decode(label, prob, want, plain=True):
    """lane_decode vs lane_decode_plain on one problem (plain=False: only
    against the bits), and against the bits that went in where there are
    any; returns the largest absolute difference of the bit words (must be
    0)."""
    t0 = time.time()
    got = tld.lane_decode(*prob)
    torch.cuda.synchronize()
    t_k = time.time() - t0
    t0 = time.time()
    if plain:
        ref = tld.lane_decode_plain(*prob)
    else:
        packed = np.packbits(want.astype(bool), axis=1, bitorder="little")
        ref = torch.from_numpy(packed.view(np.int32)).to(got.device)
    torch.cuda.synchronize()
    t_p = time.time() - t0
    err = max_abs_diff([got], [ref])
    inverts = want is None or np.array_equal(tld.unpack_bits(got), want)
    log(f"decode kernel vs plain {label}: max_abs_err={err} ones="
        f"{int(tld.unpack_bits(ref).sum())} stream_bytes="
        f"{int(prob[1][-1])} "
        f"{'' if want is None else f'inverts the encoder: {inverts} '}"
        f"(first call {t_k:.3f} s, {'plain' if plain else 'bits'} "
        f"{t_p:.1f} s)")
    if err or not torch.equal(got, ref):
        raise AssertionError(f"decode kernel != plain for {label}")
    if not inverts:
        raise AssertionError(f"decode does not invert the encoder: {label}")
    return err


def phase_decode_kernel_vs_plain(dev, cases):
    worst = 0
    for kind, L, B in cases:
        prob, want = decode_problem(kind, L, B, L + B, dev)
        worst = max(worst, check_decode(f"{kind} L={L} B={B}", prob, want))
    prob, want = one_long_lane(70000, 11, dev)
    worst = max(worst, check_decode("host encoder L=1 B=70000", prob, want))
    prob, want = one_long_lane(LONE_UNIT, 12, dev)
    worst = max(worst, check_decode(f"host encoder L=1 B={LONE_UNIT}", prob,
                                    want, plain=False))
    return worst


def decompress_stages(blob, dev, timed):
    """device_decompress phase by phase; timed(name, fn) runs and times each
    stage.  Returns (output bytes, units, the device's bins per unit)."""
    host_out, units = timed("A host model pass",
                            lambda: tpipe.record_units(blob))
    *arrays, spans = timed("pack", lambda: tpipe.pack_units(units))
    prob = timed("upload", lambda: tld.from_numpy_problem(*arrays, dev))
    bitw = timed("kernel", lambda: tld.lane_decode(*prob))
    words = timed("read-back", lambda: bitw.cpu().numpy())
    unit_bits = timed("split", lambda: tpipe.split_unit_bits(
        words, arrays[3], spans))
    out = timed("C host assembly",
                lambda: tpipe.assemble_units(blob, unit_bits))
    if out != host_out:
        raise AssertionError("the staged decode differs from the host pass")
    return out, units, unit_bits


def phase_decode_main_path(dev, containers):
    """device_decompress on real containers, held to the original file and
    to the host decoder; returns the kernel's launches on that path."""
    made = []
    for clip, scope, B in containers:
        data = open(os.path.join(ROOT, "data", clip), "rb").read()
        blob = (codec.compress(data, scope=scope, substream_bins=B) if B
                else native.compress(data, scope=scope))
        made.append((f"{clip} {scope} B={B}", data, blob))
    tld.lane_decode.launches = 0
    for label, data, blob in made:
        t0 = time.time()
        out = device_decompress(blob, device=dev)
        dt = time.time() - t0
        if out != data:
            raise AssertionError(f"{label}: device_decompress != the file")
        log(f"decode main path {label}: {len(blob)} -> {len(out)} bytes, "
            f"equal to the original file (device_decompress {dt:.3f} s)")
    launches = tld.lane_decode.launches
    log(f"decode main path: lane_decode.launches={launches}")
    if launches <= 0:
        raise AssertionError("device_decompress never launched lane_decode")
    for label, data, blob in made:
        if codec.decompress(blob) != data:
            raise AssertionError(f"{label}: codec.decompress != the file")
        ms = {}

        def timed(name, fn):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize(dev)
            ms[name] = (time.perf_counter() - t0) * 1e3
            return res

        out, units, unit_bits = decompress_stages(blob, dev, timed)
        if out != data or unit_bits != [m.rec_bits for m in units]:
            raise AssertionError(f"{label}: the device's bins differ from "
                                 f"the host model pass's")
        counts = [len(m.rec_p1s) for m in units]
        log(f"decode stages {label}: {len(units)} units, {sum(counts)} bins "
            f"(longest {max(counts)}), bins equal the recorded bins, "
            f"codec.decompress equal; ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    return launches


def decode_bound(prob):
    """(bound_ms of one lane_decode call, both its terms for the log) from
    its inputs: the stream bytes, p1, lens and offsets read once, the bit
    words written once; a renorm step for each stream byte (a lane's steps
    are its bytes, plus the zeros its encoder stripped, less one)."""
    stream, offs, p1u16, lens = prob
    L, Bp = p1u16.shape
    n_stream = int(offs[-1])
    n_bytes = n_stream + offs.numel() * 8 + L * Bp * 2 + L * 4 + L * Bp // 8
    n_bins = int(lens.clamp(0, Bp).sum())
    n_ops = lane_ops(DECODE_OPS, n_bins, n_stream)
    return (*bound_ms(n_bytes, n_ops), bound_terms(n_bytes, n_ops))


def phase_decode_full(dev, group, card):
    """The full dispatch group's streams through lane_decode, then the
    longest pinned v1 unit alone, then entry()'s step."""
    streams, p1u16, bitw, lens = group
    L, B = p1u16.shape
    prob = tld.from_numpy_problem(*tld.pack_streams(streams), p1u16, lens, dev)
    got = tld.lane_decode(*prob)  # warm-up
    if not np.array_equal(got.cpu().numpy(), bitw):
        raise AssertionError("full group: decoded bits != the input bits")
    k1 = cuda_ms(lambda: tld.lane_decode(*prob), 5)
    ref = []
    plain = cuda_ms(lambda: ref.append(tld.lane_decode_plain(*prob)), 1)
    k2 = cuda_ms(lambda: tld.lane_decode(*prob), 5)
    err = max_abs_diff([got], ref)
    if err or not torch.equal(got, ref[0]):
        raise AssertionError("full group: decode kernel != plain")
    ms = (k1 + k2) / 2
    bound, by, terms = decode_bound(prob)
    chain = B * DECODE_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3
    log(f"decode full group [{L}, {B}] on {card}: bits equal the group's "
        f"input bits, kernel = plain at the full group; kernel {k1:.3f} / "
        f"{k2:.3f} ms (mean {ms:.3f} ms, {L * B / (ms / 1e3):.4g} bins/s), "
        f"plain {plain:.1f} ms; bound {bound:.3f} ms by {by} ({terms}), the "
        f"kernel is at {bound / ms:.1%} of it; a lane's chain "
        f"floor ({B} bins x {DECODE_CHAIN_CYCLES} cycles) {chain:.3f} ms, "
        f"the kernel is at {chain / ms:.1%} of that")
    del got, ref, prob
    for n in (1, 31, 33, L - 1):  # a block's edges, against the input bits
        part = tld.from_numpy_problem(*tld.pack_streams(streams[:n]),
                                      p1u16[:n], lens[:n], dev)
        if not np.array_equal(tld.lane_decode(*part).cpu().numpy(), bitw[:n]):
            raise AssertionError(f"full group: the first {n} lanes decoded "
                                 f"alone differ from their input bits")
    log(f"decode full group: its first 1, 31, 33 and {L - 1} lanes decoded "
        f"alone equal their input bits")

    data = open(os.path.join(ROOT, "data", "mbaff_b.mkv"), "rb").read()
    _, units = tpipe.record_units(native.compress(data, scope="gop"))
    longest = max(units, key=lambda m: len(m.rec_p1s))
    *arrays, spans = tpipe.pack_units([longest])
    prob = tld.from_numpy_problem(*arrays, dev)
    unit_bits = tpipe.split_unit_bits(tld.lane_decode(*prob).cpu().numpy(),
                                      arrays[3], spans)
    if unit_bits != [longest.rec_bits]:
        raise AssertionError("longest v1 unit: the device's bins differ from "
                             "the host model pass's")
    one = cuda_ms(lambda: tld.lane_decode(*prob), 5)
    n = len(longest.rec_p1s)
    log(f"decode longest v1 unit (mbaff_b.mkv gop, {n} bins, one thread) on "
        f"{card}: kernel {one:.3f} ms = {one * 1e6 / n:.1f} ns a bin; chain "
        f"floor {n * DECODE_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3:.3f} ms")

    step, args = graft_entry.entry(dev)
    before = tlc.lane_encode.launches
    out, nbytes, overflow = step(*args)
    entry_launches = tlc.lane_encode.launches - before
    raw = [t.cpu().numpy() for t in tlc.lane_encode(*args)]
    want = tlc.finalize_lanes(*raw, args[2].cpu().numpy())
    out, nbytes = out.cpu().numpy(), nbytes.cpu().numpy()
    if bool(overflow) or want != [bytes(out[l, : nbytes[l]])
                                  for l in range(len(want))]:
        raise AssertionError("entry(): the step's bytes != finalize_lanes")
    log(f"entry(): step on the card equals finalize_lanes "
        f"({sum(map(len, want))} bytes in {len(want)} lanes), lane_encode "
        f"launches {entry_launches}")
    return err, ms, plain, bound, by, entry_launches


def nonempty_shards(n_rows, n):
    return sum(hi > lo for lo, hi in tmesh.shard_ranges(n_rows, n))


def phase_mesh_main_path(dev, clips):
    """device_compress(mesh=...) with several shards on card 0, both paths,
    and the sharded decode; returns the launches of lane_encode_streams_idx
    (the index form, which native traces take), est_encode, lane_decode
    and est_unpack in the meshed calls.  The mesh cuts traces: one group a
    non-empty shard, each shard's lanes far under a group's rows."""
    counts = [0, 0, 0, 0]  # launches of the meshed calls alone
    B = MESH_B
    for clip in clips:
        data = open(os.path.join(ROOT, "data", clip), "rb").read()
        want = device_compress(data, scope="gop", substream_bins=B,
                               device=dev)
        if want != codec.compress(data, scope="gop", substream_bins=B):
            raise AssertionError(f"{clip}: port != codec.compress")
        traces = extract_traces(data, scope="gop", want_slots=False)[3]
        L = tlc.pack_lanes(traces, B)[0].shape[0]
        if L > tlc.GROUP_ROWS:
            raise AssertionError(f"{clip}: {L} lanes, more than a group")
        for n in MESH_SHARDS:
            before = tlc.lane_encode_streams_idx.launches
            t0 = time.time()
            out = device_compress(data, mesh=make_mesh(n, device=dev),
                                  scope="gop", substream_bins=B)
            dt = time.time() - t0
            grew = tlc.lane_encode_streams_idx.launches - before
            counts[0] += grew
            if out != want:
                raise AssertionError(f"{clip} n={n}: mesh != no mesh")
            if native.decompress(out, 0) != data:
                raise AssertionError(f"{clip} n={n}: does not roundtrip")
            if grew != nonempty_shards(len(traces), n):
                raise AssertionError(
                    f"{clip} n={n}: {grew} launches for "
                    f"{nonempty_shards(len(traces), n)} non-empty shards of "
                    f"{len(traces)} traces")
            log(f"mesh {clip} n={n}: {len(traces)} traces, {L} lanes, "
                f"{grew} launches, equal to "
                f"the call without a mesh and to codec.compress, roundtrips "
                f"(device_compress {dt * 1e3:.1f} ms)")
    n = MESH_FULL
    for clip, scope in EST_MESH_CASES:
        data = open(os.path.join(ROOT, "data", clip), "rb").read()
        n_traces = len(extract_traces(data, scope=scope)[3])
        before = tec.est_encode.launches
        unpacked = tec.est_unpack.launches
        t0 = time.time()
        out = device_compress(data, mesh=make_mesh(n, device=dev),
                              scope=scope, substream_bins=0)
        dt = time.time() - t0
        grew = tec.est_encode.launches - before
        counts[1] += grew
        counts[3] += tec.est_unpack.launches - unpacked
        if tec.est_unpack.launches - unpacked != grew:
            raise AssertionError(f"{clip} {scope}: est_unpack launches != "
                                 f"est_encode launches under the mesh")
        if out != native.compress(data, scope=scope):
            raise AssertionError(f"{clip} {scope}: est mesh != native")
        if grew != nonempty_shards(n_traces, n):
            raise AssertionError(f"{clip} {scope}: {grew} est launches for "
                                 f"{n_traces} traces on {n} shards")
        log(f"est mesh {clip} {scope} n={n}: {n_traces} traces, {grew} "
            f"launches, equal to native.compress "
            f"(device_compress {dt * 1e3:.1f} ms)")
    # the decode direction: lanes of real traces over the mesh
    data = open(os.path.join(ROOT, "data", "mbaff_b.mkv"), "rb").read()
    traces = [t for t in extract_traces(data, scope="gop")[3] if len(t)]
    bitp1, lens, _ = tlc.split_lanes(traces, 2048)
    streams = tlc.lane_streams_device(bitp1, lens, dev)
    p1s = bitp1 & 0xFFFF
    whole = tld.decode_streams_lanes(streams, p1s, lens, device=dev)
    live = np.arange(bitp1.shape[1])[None, :] < lens[:, None]
    if not np.array_equal(whole.cpu().numpy(), ((bitp1 >> 16) & 1) * live):
        raise AssertionError("decode_streams_lanes: bits != the input bits")
    for n in MESH_SHARDS:
        before = tld.lane_decode.launches
        got = tld.decode_streams_lanes(streams, p1s, lens,
                                       mesh=make_mesh(n, device=dev))
        grew = tld.lane_decode.launches - before
        counts[2] += grew
        if not torch.equal(got, whole) or grew != nonempty_shards(len(lens), n):
            raise AssertionError(f"sharded decode n={n}: differs, or {grew} "
                                 f"launches")
        log(f"mesh decode n={n}: {len(lens)} lanes, {grew} launches, equal "
            f"to the unsharded call and to the input bits")
    log(f"mesh main path: lane_encode_streams_idx.launches={counts[0]} "
        f"est_encode.launches={counts[1]} lane_decode.launches={counts[2]} "
        f"est_unpack.launches={counts[3]}")
    if min(counts) <= 0:
        raise AssertionError("a mesh path never launched its kernel")
    return counts


def mesh_rows(mesh, p1, bitw, lens, collect=tlc.lane_collect):
    """Numpy lane rows cut over `mesh` by its shard loop (run_sharded),
    each shard through a LaneBatcher of its own, read back by `collect`:
    every lane's stream bytes."""

    def dispatch(lo, hi, d):
        bat = tlc.LaneBatcher(d)
        bat.add(p1[lo:hi], bitw[lo:hi], lens[lo:hi])
        return bat.dispatch()

    parts = tmesh.run_sharded(len(lens), mesh, dispatch, collect)
    return [s for p in parts for s in p]


def staged_ms(dev, mesh, p1u16, bitw, lens):
    """mesh_rows in its two phases, the device idle between them: ms of
    dispatch (upload + launch, every shard, until the card is done) and of
    the drain (read-back + slicing, every shard), and the stream bytes."""
    marks = []

    def collect(pending):
        if not marks:
            torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())
        return tlc.lane_collect(pending)

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    streams = mesh_rows(mesh, p1u16, bitw, lens, collect)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    return ((marks[0] - t0) * 1e3, (t1 - marks[0]) * 1e3), streams


def phase_mesh_full(dev, group, card):
    """Phase 5's full group as numpy rows cut over a mesh (mesh_rows),
    beside the unsharded call: whole calls on the host clock in turns,
    kernels by CUDA events, and the stage split of both."""
    want, p1u16, bitw, lens = group
    L, B = p1u16.shape
    n = MESH_FULL
    mesh = make_mesh(n, device=dev)

    def whole(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        streams = fn()
        torch.cuda.synchronize(dev)
        return streams, (time.perf_counter() - t0) * 1e3

    def plain_call():
        return tlc.lane_streams_device_compact(p1u16, bitw, lens, dev)

    times = {"unsharded": [], "mesh": []}
    before = tlc.lane_encode_streams.launches
    for name, fn in (("unsharded", plain_call),
                     ("mesh", lambda: mesh_rows(mesh, p1u16, bitw, lens))
                     ) * 2 + (("unsharded", plain_call),):
        streams, ms = whole(fn)
        times[name].append(ms)
        if streams != want:
            raise AssertionError(f"full group, {name}: streams differ from "
                                 f"phase 5's")
    if tlc.lane_encode_streams.launches - before != 3 + 2 * n:
        raise AssertionError("full group: unexpected launch count")
    log(f"mesh full group [{L}, {B}] n={n} on {card}: streams equal the "
        f"single launch's; whole call on the host clock, in turns, ms: "
        f"unsharded {', '.join(f'{t:.1f}' for t in times['unsharded'])}; "
        f"mesh {', '.join(f'{t:.1f}' for t in times['mesh'])}")

    # the kernels alone: one launch, against n launches on n streams
    M = tlc.max_bytes(B)
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, dev)

    def sharded_kernels():
        here = torch.cuda.current_stream(dev)

        def launch(lo, hi, d):
            torch.cuda.current_stream(d).wait_stream(here)
            tlc.lane_encode_streams(*(t[lo:hi] for t in prob), M)

        def join(_):
            here.wait_stream(torch.cuda.current_stream(dev))

        tmesh.run_sharded(L, mesh, launch, join)

    sharded_kernels()  # warm-up
    one = cuda_ms(lambda: tlc.lane_encode_streams(*prob, M), 5)
    many = cuda_ms(sharded_kernels, 5)
    one2 = cuda_ms(lambda: tlc.lane_encode_streams(*prob, M), 5)
    log(f"mesh full group lane_encode_streams on {card}: one launch {one:.3f} / "
        f"{one2:.3f} ms, {n} launches on {n} streams {many:.3f} ms")
    del prob

    split_one, s1 = staged_ms(dev, (dev,), p1u16, bitw, lens)
    split_n, s2 = staged_ms(dev, mesh, p1u16, bitw, lens)
    if s1 != want or s2 != want:
        raise AssertionError("full group: the staged streams differ")
    for name, sp in (("unsharded", split_one), (f"mesh n={n}", split_n)):
        log(f"mesh full group phases, {name}, on {card}, ms (the device "
            f"idle between them): dispatch (upload + launch) {sp[0]:.2f}, "
            f"drain (read-back + slicing) {sp[1]:.2f}, sum {sum(sp):.2f}")

    if torch.cuda.device_count() > 1:
        cards = make_mesh()
        streams, ms = whole(lambda: mesh_rows(cards, p1u16, bitw, lens))
        if streams != want:
            raise AssertionError("full group over the distinct cards differs")
        log(f"mesh full group over {len(cards)} distinct cards: streams "
            f"equal, whole call {ms:.1f} ms (first call on the other cards)")
    else:
        log("mesh over distinct cards: 1 card present, not run")


def _smoke_step_rank(rank, world, device, arrays):
    """multichip_step on one rank of phase 13."""
    before = tec.est_encode.launches
    out, lens, total = tpipe.multichip_step(*arrays, device=device)
    return {"out": out, "lens": lens, "total": total,
            "launches": tec.est_encode.launches - before,
            "device": str(ranks.rank_device(device, rank))}


def _smoke_multihost_rank(rank, world, device, clip):
    """compress_sharded / stitch and decompress_sharded /
    stitch_decompressed on one rank of phase 13; every rank checks."""
    data = open(clip, "rb").read()
    t0 = time.perf_counter()
    frag = multihost.compress_sharded(data, rank, world, threads=1)
    t1 = time.perf_counter()
    blob = multihost.stitch(multihost.allgather_bytes(frag))
    t2 = time.perf_counter()
    if blob != native.compress(data, scope="gop"):
        raise AssertionError("stitched container != native.compress")
    t3 = time.perf_counter()
    part = multihost.decompress_sharded(blob, rank, world, threads=1)
    t4 = time.perf_counter()
    parts = multihost.allgather_bytes(part)
    t5 = time.perf_counter()
    if multihost.stitch_decompressed(parts) != data:
        raise AssertionError("sharded decompress != the file")
    return {"fragment": len(frag), "part": len(part), "container": len(blob),
            "work_s": (t1 - t0) + (t4 - t3),
            "collectives_s": (t2 - t1) + (t5 - t4)}


def rank_times(reports):
    return "; ".join(
        f"rank {r}: start-up {rep['start_s']:.2f} s, work "
        f"{rep['result']['work_s']:.3f} s, collectives "
        f"{rep['result']['collectives_s']:.3f} s, exit at {rep['exit_s']:.2f} s"
        for r, rep in enumerate(reports))


def phase_ranks(dev, card, rank_dev=None):
    """Several processes, one rank each, sharing the card (rank_dev=None:
    rank r on cuda:{r % device_count}); returns the (lane_encode,
    est_encode) launches the ranks counted."""
    mode = ranks.compute_mode(0)
    log(f"ranks: compute mode {mode}; {torch.cuda.device_count()} card(s); "
        f"backend for 4 ranks {ranks.pick_backend(4, rank_dev)}, for 2 "
        f"ranks {ranks.pick_backend(2, rank_dev)}")
    t0 = time.time()
    reports = graft_entry.dryrun_multichip(4, device=rank_dev)
    wall = time.time() - t0
    results = [r["result"] for r in reports]
    lane_launches = sum(r["launches"] for r in results)
    log(f"dryrun_multichip(4) on {card}: passed its asserts in {wall:.2f} s "
        f"wall; backend {reports[0]['backend']}, grid {results[0]['grid']}, "
        f"{results[0]['lanes']} lanes, total {results[0]['total']} bytes, "
        f"offsets {[r['offset'] for r in results]}, devices "
        f"{[r['device'] for r in results]}, lane_encode launches "
        f"{[r['launches'] for r in results]}; {rank_times(reports)}")
    if any(r["launches"] < 1 or not r["device"].startswith("cuda")
           for r in results):
        raise AssertionError("a rank of the dry run launched no kernel")

    data = open(os.path.join(ROOT, "data", "rt_ctr.mkv"), "rb").read()
    traces = extract_traces(data, scope="slice")[3]
    arrays = tpipe.pack_traces(traces, pad_multiple=2)
    want = tec.encode_traces_est(traces, dev)
    t0 = time.time()
    reports = ranks.run_ranks(_smoke_step_rank, 2, (arrays,),
                                  device=rank_dev)
    wall = time.time() - t0
    got = []
    for res in (r["result"] for r in reports):
        got += [stream_bytes(res["out"][i], res["lens"][i])
                for i in range(len(res["lens"]))]
    total = sum(map(len, want))
    if got[: len(want)] != want or any(b for b in got[len(want):]):
        raise AssertionError("multichip_step: rows != the single-process "
                             "est streams")
    if [r["result"]["total"] for r in reports] != [total] * 2:
        raise AssertionError("multichip_step: total != the sum of the lens")
    est_launches = sum(r["result"]["launches"] for r in reports)
    log(f"multichip_step over 2 ranks on {card}: {len(want)} slice traces of "
        f"rt_ctr.mkv equal to the single-process est streams, total {total} "
        f"bytes on both ranks; backend {reports[0]['backend']}, devices "
        f"{[r['result']['device'] for r in reports]}, est_encode launches "
        f"{[r['result']['launches'] for r in reports]}; {wall:.2f} s wall, "
        f"start-up {[round(r['start_s'], 2) for r in reports]} s, exit at "
        f"{[round(r['exit_s'], 2) for r in reports]} s")
    if any(r["result"]["launches"] < 1 for r in reports):
        raise AssertionError("a rank of multichip_step launched no kernel")

    clip = os.path.join(ROOT, "data", "mbaff_b.mkv")
    t0 = time.time()
    reports = ranks.run_ranks(_smoke_multihost_rank, 2, (clip,),
                                  device=rank_dev)
    wall = time.time() - t0
    log(f"multihost over 2 ranks: compress_sharded + stitch equal to "
        f"native.compress, decompress_sharded + stitch_decompressed equal to "
        f"the file (mbaff_b.mkv, fragments "
        f"{[r['result']['fragment'] for r in reports]} bytes, parts "
        f"{[r['result']['part'] for r in reports]} bytes); backend "
        f"{reports[0]['backend']}; {wall:.2f} s wall; {rank_times(reports)}")
    return lane_launches, est_launches


def phase_cli():
    """The command line, as a user starts it."""
    src = os.path.join(ROOT, "data", "rt_ctr.mkv")
    data = open(src, "rb").read()

    def cli(*argv):
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "avrecode_tpu_torch", *argv], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"cli {argv}: exit code {res.returncode}\n"
                                 f"{res.stdout}{res.stderr}")
        log(f"cli {' '.join(argv[:-2] if len(argv) > 3 else argv[:-1])}: exit "
            f"0 in {time.time() - t0:.2f} s; {res.stderr.strip()[:100]}")

    cli("roundtrip", src)
    with tempfile.TemporaryDirectory() as tmp:
        avtr, out = os.path.join(tmp, "c.avtr"), os.path.join(tmp, "c.out")
        cli("--hosts", "2", "compress", src, avtr)
        cli("--hosts", "2", "decompress", avtr, out)
        blob, back = open(avtr, "rb").read(), open(out, "rb").read()
    if blob != native.compress(data, scope="gop") or back != data:
        raise AssertionError("cli --hosts 2: bytes differ")
    log(f"cli: --hosts 2 container equal to native.compress ({len(blob)} "
        f"bytes), decompressed bytes equal to the input ({len(back)})")


def bench_corpus():
    """Phase 15's corpus: the pinned files (BENCH_SET) and the number of
    copies of them that passes BENCH_GROUPS full dispatch groups at the
    bench's B.  Returns (paths, copies, lane rows a copy at that B)."""
    paths = [os.path.join(ROOT, "data", n) for n in BENCH_SET]
    rows = 0
    for p in paths:
        traces = extract_traces(open(p, "rb").read(), scope="gop",
                                want_slots=False)[3]
        rows += tlc.pack_lanes(traces, bench.CORPUS_B)[0].shape[0]
    return paths, BENCH_GROUPS * tlc.GROUP_ROWS // rows + 1, rows


def group_ring_bytes():
    """The pinned host memory of the process's group staging buffers, as
    text: the bytes asked for, and as PyTorch's host caching allocator
    holds them (each allocation rounded up to a power of two)."""
    sizes = [t.untyped_storage().nbytes() for ring in tlc._groups.rings.values()
             for g in ring for t in (g.p1, g.bitw, g.lens)]
    held = sum(1 << max(n - 1, 0).bit_length() for n in sizes)
    return (f"all the process's group buffers ({len(sizes) // 3}) pin "
            f"{sum(sizes)} bytes asked, {held} bytes "
            f"held")


def phase_ring_overrun(dev, hosts):
    """device_compress_corpus on phase 15's corpus at B = RING_B, with more
    dispatch groups a pass than the staging ring holds (GROUP_RING of each
    form), twice: as a user calls it, then with the card held up by a
    sleep kernel queued first, so that every group's upload waits behind
    it and a group buffer refilled before its copy had run would send the
    rows of a later group.  Every pass's containers equal the first pass's
    and the host codec's (codec.compress of each distinct file; `hosts`
    holds phase 4's).  Each pass's peak device memory above what was
    allocated before it stays under RING_PEAK_GROUPS groups' inputs in the
    index form (the groups are read back as they go, so it does not grow
    with their count); its peak RSS is printed.  Returns the launches of
    lane_encode_streams_idx."""
    paths, copies, _ = bench_corpus()
    datas = [open(p, "rb").read() for p in paths]
    want = [hosts.get((os.path.basename(p), RING_B)) or codec.compress(
        d, scope="gop", substream_bins=RING_B) for p, d in zip(paths, datas)]
    Bp = -(-RING_B // tlc.CHUNK) * tlc.CHUNK
    group_inputs = tlc.GROUP_ROWS * (3 * Bp // 2 + Bp // 8 + 4)
    launches = 0
    first = None
    for stall in (False, True):
        stats = {}
        before = tlc.lane_encode_streams_idx.launches
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        allocated = torch.cuda.memory_allocated(dev)
        t0 = time.time()
        with PeakRSS() as rss:
            if stall:
                torch.cuda._sleep(RING_STALL_CYCLES)
            outs = device_compress_corpus(datas * copies, scope="gop",
                                          substream_bins=RING_B, device=dev,
                                          stats=stats)
        dt = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev) - allocated
        launches += tlc.lane_encode_streams_idx.launches - before
        rings = {k: len(r) for k, r in tlc._groups.rings.items()
                 if k[1] == RING_B}
        log(f"ring overrun B={RING_B}{', the card stalled first' if stall else ''}"
            f": {len(outs)} files, {stats['dispatches']} dispatches, "
            f"{stats['bins']} bins, {dt:.1f} s; device peak {peak} bytes "
            f"above the {allocated} allocated before (a group's inputs "
            f"{group_inputs}); {rss.text()}; group buffers (index form, Bp, "
            f"rows): {rings}; {group_ring_bytes()}")
        if first is None:
            first = outs
        if (stats["dispatches"] <= tlc.GROUP_RING + 1 or outs != first
                or outs != want * copies):
            raise AssertionError("ring overrun: too few groups, or a pass's "
                                 "containers differ from the first pass's or "
                                 "from the host codec's")
        if peak >= RING_PEAK_GROUPS * group_inputs:
            raise AssertionError(
                f"ring overrun: the pass's device peak, {peak} bytes, is not "
                f"under {RING_PEAK_GROUPS} groups' inputs "
                f"({RING_PEAK_GROUPS * group_inputs} bytes)")
    return launches


def phase_bench():
    """The port's corpus driver, as a user starts its device section, over
    more than BENCH_GROUPS full dispatch groups of real traces."""
    paths, copies, rows = bench_corpus()
    corpus = paths * copies
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "avrecode_tpu_torch.bench", "--device-corpus",
         *corpus], cwd=ROOT, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
    if res.returncode != 0 or not lines:
        raise AssertionError(f"bench --device-corpus: exit code "
                             f"{res.returncode}\n{res.stderr[-3000:]}")
    line = json.loads(lines[-1])
    files = line.pop("files")
    log(f"bench: {len(corpus)} files ({copies} copies of {len(paths)}, "
        f"{rows} lane rows a copy at B={bench.CORPUS_B}) in "
        f"{time.time() - t0:.1f} s, {sum(f['roundtrip'] == 'OK' for f in files)}"
        f" roundtrip OK; per file: "
        f"{ {f['file']: f['ratio_pct'] for f in files[:len(paths)]} }")
    log("bench stderr: " + " | ".join(
        l for l in res.stderr.splitlines() if l.startswith("device corpus")))
    log(f"bench: each pass's lane pack, summed over the extraction workers, "
        f"{line['pack_s']} s; its rows copied into the groups on the main "
        f"thread {line['copy_s']} s; the pass {line['pass_s']} s")
    line["files"] = len(files)
    print(json.dumps(line), flush=True)
    if (line["roundtrip_failures"] != 0 or len(files) != len(corpus)
            or line["kernel"] != "cuda-lane" or line["dispatches"] < 3
            or len(line["pack_s"]) != len(line["pass_s"])
            or len(line["copy_s"]) != len(line["pass_s"])
            or min(line["kernel_launches"]) < line["dispatches"]
            or not line["device_name"] or not line["power_limit"]):
        raise AssertionError(f"bench: the line fails its checks: {line}")


def phase_verify():
    """tools/gpu_verify.py, as a user starts it, writing its record to a
    temporary file: exit code 0 and every check ok."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "GPU_VERIFY.json")
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "gpu_verify.py"),
             "--out", out], cwd=ROOT, capture_output=True, text=True,
            timeout=VERIFY_TIMEOUT_S)
        record = {}
        if os.path.exists(out):
            with open(out) as f:
                record = json.load(f)
    checks = record.get("checks", {})
    for name, c in checks.items():
        log(f"verify {name}: ok={c['ok']} {c.get('launches', c.get('error'))}")
    log(f"verify: exit code {res.returncode} in {time.time() - t0:.1f} s, "
        f"{sum(c['ok'] for c in checks.values())} of {len(checks)} checks ok")
    if (res.returncode != 0 or not checks or not record.get("all_ok")
            or not all(c["ok"] for c in checks.values())):
        raise AssertionError(f"gpu_verify.py failed:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-3000:]}")


def main():
    # 1 device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    clock = PhaseClock()
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
    log(f"build: lane_encode, lane_encode_streams (and its index form), "
        f"unpack_p1_idx, est_encode, est_unpack and lane_decode kernels "
        f"{t_k:.1f} s "
        f"({_build.library_path().name}); {host_lib.name} ready after "
        f"{time.time() - t0:.1f} s")
    log(_build.build_log().strip())
    clock.mark("1-2 device and build")

    # 3 kernel vs plain on the card
    err = phase_kernel_vs_plain(dev, [
        ("random", 1, 256), ("random", 5, 32), ("random", 33, 96),
        ("random", 70, 160), ("random", 31, 4128), ("random", 1000, 4096),
        ("carry", 1000, 4096), ("carry", 97, 1184), ("zero", 40, 512)])
    s_err = max(phase_streams_vs_plain(dev, STREAM_CASES),
                lone_lane_vs_host(dev, LONE_LANE, 5))
    i_err, u_err = phase_streams_idx_vs_plain(dev, STREAM_CASES)
    i_err = max(i_err, lone_lane_vs_host(dev, LONE_LANE, 6, index=True))
    # the fallback paths: counts from 0 to just after each
    _zero_counts()
    zero_u16 = phase_zero_p1(dev)
    _zero_counts()
    overflow = phase_overflow(dev, 1000, 4096)
    clock.mark("3 lane kernels vs plain")

    # 4 main path; the launch counts cover exactly this phase: one fused
    # launch of the index form a device_compress call and a corpus call
    # (native traces' p1 lie on the squash grid), none of lane_encode,
    # lane_encode_streams or unpack_p1_idx
    _zero_counts()
    hosts, idx_paths = phase_main_path(dev, (4096, 16384), MAIN_CLIPS)
    others = {n: getattr(tlc, n).launches for n in (
        "lane_encode_streams", "lane_encode", "unpack_p1_idx")}
    log(f"main path: lane_encode_streams_idx.launches={idx_paths}, {others}")
    if (idx_paths != {"device_compress": 2 * len(MAIN_CLIPS),
                      "device_compress_corpus": 2} or any(others.values())):
        raise AssertionError("main path: not one lane_encode_streams_idx "
                             "launch a call, or another lane kernel launched")
    # the u16 form on the same entry point, where p1 leave the squash image
    _zero_counts()
    off_image = phase_off_image(dev)
    # the corpus path over more groups than the staging ring holds
    _zero_counts()
    idx_paths["device_compress_corpus, ring overrun"] = phase_ring_overrun(
        dev, hosts)

    # 5 full-size dispatch: the kernels against plain at full width and
    # depth, both upload forms
    ((full_lane_err, ms, plain_ms, lane_bound, lane_by),
     (full_s_err, s_ms, s_plain_ms, s_bound, s_by),
     (full_i_err, i_ms, i_plain_ms, i_bound, i_by),
     (full_u_err, u_ms, u_plain_ms, u_bound, u_by),
     full_group) = phase_full_dispatch(dev, CLIPS, FULL_L, FULL_B, card)
    clock.mark("4-5 lane main path and full group")

    # 6 est kernel vs plain on the card
    est_err = phase_est_kernel_vs_plain(dev, EST_CASES + [EST_SWEEP])

    # 7 est main path; the launch count covers exactly this phase
    tec.est_encode.launches = tec.est_unpack.launches = 0
    phase_est_main_path(dev, CLIPS)
    est_launches = tec.est_encode.launches
    unpack_launches = tec.est_unpack.launches
    log(f"est main path: est_encode.launches={est_launches}, "
        f"est_unpack.launches={unpack_launches}")
    if est_launches <= 0:
        raise AssertionError("est main path never launched the est_encode kernel")
    if unpack_launches != est_launches:
        raise AssertionError("est main path: not one est_unpack a launch")

    # 8 est full size
    full_err, est_ms, est_plain_ms, est_bound, est_by = phase_est_full(
        dev, CLIPS, EST_S, card)
    un_err, un_ms, un_plain_ms, un_bound, un_by = phase_est_unpack(dev, card)
    phase_est_archive(dev, card, archive_group())
    clock.mark("6-8 est path")

    # 9 decode kernel vs plain on the card
    dec_err = phase_decode_kernel_vs_plain(dev, [
        ("random", 1, 256), ("random", 5, 32), ("random", 33, 96),
        ("random", 70, 160), ("random", 31, 4128), ("random", 1000, 4096),
        ("carry", 1000, 4096), ("carry", 97, 1184), ("zero", 40, 512),
        ("bytes", 50, 1184), ("bytes", 200, 4096), ("random", 8191, 256),
        ("edges", 1, 4096), ("edges", 31, 4096), ("edges", 33, 1024),
        ("ffrun", 33, 2048), ("bytes", 33, 4096)])

    # 10 decode main path; phase_decode_main_path counts the launches of
    # exactly its device_decompress calls
    dec_launches = phase_decode_main_path(dev, DECODE_CONTAINERS)

    # 11 decode at full size
    (dec_full_err, dec_ms, dec_plain_ms, dec_bound, dec_by,
     entry_lane) = phase_decode_full(dev, full_group, card)
    clock.mark("9-11 decode direction")

    # 12 the mesh: one process, several shards on the card
    mesh_lane, mesh_est, mesh_dec, mesh_unpack = phase_mesh_main_path(
        dev, CLIPS)
    phase_mesh_full(dev, full_group, card)
    del full_group
    clock.mark("12 mesh")

    # 13 ranks: several processes share the card
    rank_lane, rank_est = phase_ranks(dev, card)
    clock.mark("13 ranks")

    # 14 the command line
    phase_cli()
    clock.mark("14 command line")

    # 15 the corpus driver over several full dispatch groups
    phase_bench()
    clock.mark("15 bench")

    # 16 the verify tool, every check
    phase_verify()
    clock.mark("16 verify")

    lane_paths = {"entry": entry_lane,
                  "overflow_fallback": overflow["lane_encode"],
                  "dryrun_multichip": rank_lane}
    stream_paths = {"lane_streams_device_compact, p1 off the squash image":
                    off_image,
                    "lane_streams_device_compact, a valid p1 = 0": zero_u16,
                    "overflow_fallback": overflow["lane_encode_streams"]}
    idx_paths["mesh"] = mesh_lane
    idx_paths["overflow_fallback"] = overflow["lane_encode_streams_idx"]
    unpack_paths = {"overflow_fallback": overflow["unpack_p1_idx"]}
    est_paths = {"device_compress": est_launches, "mesh": mesh_est,
                 "multichip_step": rank_est}
    dec_paths = {"device_decompress": dec_launches, "mesh": mesh_dec}
    est_unpack_paths = {"device_compress": unpack_launches,
                        "mesh": mesh_unpack}
    for name, paths in (("lane_encode", lane_paths), ("est_encode", est_paths),
                        ("lane_decode", dec_paths),
                        ("lane_encode_streams", stream_paths),
                        ("lane_encode_streams_idx", idx_paths),
                        ("unpack_p1_idx", unpack_paths),
                        ("est_unpack", est_unpack_paths)):
        log(f"{name} launches by main path: {paths}")
        if min(paths.values()) <= 0:
            raise AssertionError(f"{name}: a main path launched it no time")

    print(json.dumps({"kernels": [{
        "name": "lane_encode",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/lane_encode.cu",
        "replaces": "avrecode_tpu/ops/lane_coder.py:195",
        "launches": sum(lane_paths.values()),
        "launches_by_path": lane_paths,
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
        "launches": sum(est_paths.values()),
        "launches_by_path": est_paths,
        "max_abs_err": max(est_err, full_err),
        "ms": est_ms,
        "plain_ms": est_plain_ms,
        "bound_ms": est_bound,
        "bound_by": est_by,
        "library_ms": None,  # nor an adaptive model with a range coder
    }, {
        "name": "lane_decode",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/lane_decode.cu",
        "replaces": "avrecode_tpu/ops/lane_decoder.py:80",  # an XLA scan
        "launches": sum(dec_paths.values()),
        "launches_by_path": dec_paths,
        "max_abs_err": max(dec_err, dec_full_err),
        "ms": dec_ms,
        "plain_ms": dec_plain_ms,
        "bound_ms": dec_bound,
        "bound_by": dec_by,
        "library_ms": None,  # nor a range decoder
    }, {
        "name": "lane_encode_streams",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/lane_streams.cu",
        # _lane_pipeline_jit: the Pallas kernel and the XLA finalize
        "replaces": "avrecode_tpu/ops/lane_coder.py:448",
        "launches": sum(stream_paths.values()),
        "launches_by_path": stream_paths,
        "max_abs_err": max(s_err, full_s_err),
        "ms": s_ms,
        "plain_ms": s_plain_ms,
        "bound_ms": s_bound,
        "bound_by": s_by,
        "library_ms": None,  # nor a range coder with its finalize
    }, {
        "name": "lane_encode_streams_idx",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/lane_streams.cu",
        # _lane_pipeline_idx_jit: the 12-bit unpack and take, the Pallas
        # kernel and the XLA finalize
        "replaces": "avrecode_tpu/ops/lane_coder.py:426",
        "launches": sum(idx_paths.values()),
        "launches_by_path": idx_paths,
        "max_abs_err": max(i_err, full_i_err),
        "ms": i_ms,
        "plain_ms": i_plain_ms,
        "bound_ms": i_bound,
        "bound_by": i_by,
        "library_ms": None,  # nor a range coder fed from a table
    }, {
        "name": "unpack_p1_idx",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/p1_idx.cu",
        # the unpack and take inside _lane_pipeline_idx_jit (XLA there)
        "replaces": "avrecode_tpu/ops/lane_coder.py:432",
        "launches": sum(unpack_paths.values()),
        "launches_by_path": unpack_paths,
        "max_abs_err": max(u_err, full_u_err),
        "ms": u_ms,
        "plain_ms": u_plain_ms,
        "bound_ms": u_bound,
        "bound_by": u_by,
        # no one PyTorch call takes 12-bit fields apart and looks them up
        "library_ms": None,
    }, {
        "name": "est_unpack",
        "route": "cuda",
        "source": "avrecode_tpu_torch/csrc/est_unpack.cu",
        # none: the JAX package packs the est problem on the host (numpy)
        "replaces": None,
        "launches": sum(est_unpack_paths.values()),
        "launches_by_path": est_unpack_paths,
        "max_abs_err": un_err,
        "ms": un_ms,
        "plain_ms": un_plain_ms,
        "bound_ms": un_bound,
        "bound_by": un_by,
        "library_ms": None,  # no one PyTorch call unpacks ragged records
    }]}))
    print(card)
    # the smoke drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
