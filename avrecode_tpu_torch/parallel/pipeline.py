"""Compression pipeline with the device entropy stage (PyTorch + CUDA).

Counterpart of avrecode_tpu/parallel/pipeline.py:

  host   — container demux + slice parse + trace extraction (the
           native extractor, or the Python reference parser),
  device — substream_bins > 0: the lane-parallel estimator-free coder
           with the finalize fused in (ops/lane_coder.py,
           lane_encode_streams_idx on 12-bit squash indices, or
           lane_encode_streams on uint16 p1 where a trace's p1 leave the
           squash image);
           substream_bins = 0: the adaptive model and the range coder
           (ops/est_coder.py), one trace per thread.  The CUDA kernel runs
           on a card, the plain torch version on the CPU,
  host   — carry folding (est path), sub-stream envelopes (lane path) and
           the container (v2 for the lane path, v1 for the est path).

device_compress(data, scope=..., substream_bins=B) produces a container
BYTE-IDENTICAL to codec.compress(data, scope=..., substream_bins=B).

The JAX package expresses two shapes of parallelism with one Mesh; the port
uses PyTorch's idiom for each:

  one process, several devices  device_compress(mesh=...): the mesh is a
           tuple of torch.devices (parallel/mesh.py; a device is a mesh of
           one), the traces are cut into contiguous shards, one a device,
           each shard runs the one-device stage, and no collective is
           needed.  Unlike the JAX package, which runs its XLA scan under a
           mesh, every shard here launches the CUDA kernels.
  several processes, one rank each  multichip_step: the SPMD function every
           rank of a torch.distributed group calls on its own rows, with the
           billing all_reduce (parallel/ranks.py and parallel/multihost.py
           hold the rest).

The decode direction, device_decompress(blob), runs the entropy decode of a
container on the device (ops/lane_decoder.py) between two host passes, and
returns bytes identical to codec.decompress(blob).
"""

import collections
import concurrent.futures
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..codec import _scan_blocks, compress, decompress, serialize_container
from ..host import native
from ..models.h264_model import RecodeModel
from ..models.trace import N_CLS, TraceModel
from ..spans import bind, call, count, current, span
from ..ops.est_coder import (
    encode_traces_est,
    est_collect,
    est_encode,
    from_numpy_traces,
    pack_rows,
)
from ..ops.estimator import pack_stream_rows
from ..ops import lane_decoder
from ..ops.lane_coder import (
    CHUNK,
    StreamingBatcher,
    auto_substream_bins,
    encode_traces_lanes,
    pack_lanes,
)
from ..utils.container import KIND_SLICE, SCOPE_GOP, SCOPE_SLICE
from .mesh import as_mesh, make_mesh
from .ranks import collective_device, rank_device

__all__ = [
    "device_compress", "device_compress_corpus", "device_decompress",
    "extract_traces", "make_mesh", "multichip_step", "pack_traces",
]


def extract_traces(data, use_native=None, scope="slice", threads=0,
                   want_slots=True):
    """Host stage: parse + verify all slices, returning (sps, pps, blocks,
    traces, stats).  Slice blocks reference their trace in the stream slot
    (GOP scope: one trace per GOP on its first slice block, b""
    continuations).

    Uses the native (C++) extractor when built, and the Python reference
    parser when it is not, when it rejects the input (unless
    use_native=True), or when use_native=False.  stats["native"] records
    which one ran.  threads: 0=auto (parallel GOP jobs, gop scope),
    1=serial.

    want_slots=False says the caller reads only each bin's (bit, p1), as
    the lane coder does: the native extractor then gives the gop scope's
    traces in the lane form (native.extract_lanes: LaneTraces, 2 bytes a
    bin) and the slice scope's NativeTraces without the slot remap (8
    bytes a bin, as want_slots=True gives them).

    In a call of an entry this is span extract, and the traces' bins
    (stats "bins") and the bytes of their per-bin records (stats
    "trace_bytes"; none for the Python parser's) are counted."""
    with span("extract"):
        out = _extract(data, use_native, scope, threads, want_slots)
    count("bins", sum(len(t) for t in out[3]))
    count("trace_bytes", sum(getattr(t, "nbytes", 0) for t in out[3]))
    return out


def _extract(data, use_native, scope, threads, want_slots):
    if use_native is not False and native.available():
        try:
            if scope == "gop" and not want_slots:
                sps, pps, blocks, traces = native.extract_lanes(
                    bytes(data), threads=threads)
            else:
                sps, pps, blocks, traces = native.extract(
                    bytes(data), scope, threads=threads,
                    want_slots=want_slots)
            return sps, pps, blocks, traces, {"native": True}
        except ValueError:
            if use_native:
                raise
    stats = {"native": False, "slices": 0, "recoded": 0, "bins": 0}
    scope_id = SCOPE_SLICE if scope == "slice" else SCOPE_GOP
    sps, pps, blocks, _ = _scan_blocks(data, scope_id, TraceModel, stats, {})
    # GOP scope: one trace per GOP on its first slice block; b""
    # continuation markers are serialized as-is, not encoded
    traces = [b[6] for b in blocks
              if b[0] == KIND_SLICE and not isinstance(b[6], bytes)]
    return sps, pps, blocks, traces, stats


def pack_traces(traces, pad_multiple=1):
    """Pad/stack traces to [S, T] arrays (S padded to a multiple of
    pad_multiple).  Returns est_coder.from_numpy_traces' argument order
    (slots, bits, pcabs, limits, valid, cls); None for no traces."""
    n = len(traces)
    if n == 0:
        return None
    T = max(max(len(t) for t in traces), 1)
    NS = max(max(len(t.limits) for t in traces), 1)
    S = -(-n // pad_multiple) * pad_multiple
    arrays = pack_rows(traces, S, T, NS)
    assert arrays[5].max(initial=0) < N_CLS, \
        "key-class id out of mixer weight range"
    return arrays


def _serialize(scope_id, sps, pps, blocks, traces, streams, substream_bins):
    finmap = {id(t): streams[i] for i, t in enumerate(traces)}

    def finisher(t):
        return t if isinstance(t, bytes) else finmap[id(t)]

    with span("serialise"):
        return serialize_container(
            scope_id, sps, pps, blocks, None, finisher=finisher,
            substream_bins=substream_bins,
        )


def device_compress(data, mesh=None, scope=None, substream_bins=4096,
                    device=None, stats=None):
    """Full compression with the device entropy stage on `device`, or
    sharded over `mesh` (parallel/mesh.make_mesh; not both).

    scope: "gop" (default with native extraction; best ratio, GOP-parallel)
    or "slice" (finest parallel grain).

    substream_bins > 0 (or "auto") selects the lane-parallel estimator-free
    coder: the recorded exact per-bin probabilities drive a bare range
    coder, one sub-stream per GPU thread.

    substream_bins=0 selects the est-on-device path: the device runs the
    adaptive model itself (counters, mixer, APM) and the range coder, one
    trace per block of stage warps, into a v1 container.

    A device is a mesh of one: a mesh cuts the traces into contiguous
    shards, and each shard runs the one-device stage of its path.

    Output is byte-identical to codec.compress(scope=...,
    substream_bins=...), with any mesh or none.

    stats (optional dict) receives the call's spans and counters, as
    device_compress_corpus's (spans.KEYS): on either path the extraction
    (extract_*, gop_*, bins, trace_bytes), the container (serialise_s) and
    the traces' release; on the lane path the pack into a group (pack_s),
    dispatch_s and upload_s, the read-back (collect_s) and the envelopes;
    on the est path each group's records and slot tables (est_pack_s),
    wait for the est kernel before (est_wait_s), upload and unpack
    (est_upload_s), launch with its range check's read-back
    (est_launch_s), read-back (est_collect_s) and host finalize
    (est_finalize_s), and the groups coded (est_launches), the groups
    closed by the card's budget (est_memory_cuts), traces (est_traces),
    padded bins (est_padded_bins) and stream bytes out (est_stored); every
    shard of a mesh adds its own."""
    mesh = as_mesh(device, mesh)
    data = bytes(data)
    if scope is None:
        scope = "gop" if native.available() else "slice"
    with call("device_compress", stats, index=0):
        return _device_compress(data, mesh, scope, substream_bins)


def _device_compress(data, mesh, scope, substream_bins):
    # the lane coder reads only (bit, p1): the lane form in the gop scope,
    # no slot remap in the slice scope; only the est path (substream_bins=0)
    # reads the slots
    sps, pps, blocks, traces, _ = extract_traces(
        data, scope=scope, want_slots=not substream_bins)
    if substream_bins == "auto":
        substream_bins = auto_substream_bins(sum(len(t) for t in traces))
    if not traces:
        return compress(data, scope=scope, substream_bins=substream_bins)
    if substream_bins:
        streams = encode_traces_lanes(traces, substream_bins, mesh=mesh)
    else:
        streams = encode_traces_est(traces, mesh=mesh)
    scope_id = SCOPE_SLICE if scope == "slice" else SCOPE_GOP
    out = _serialize(scope_id, sps, pps, blocks, traces, streams,
                     substream_bins)
    with span("extract_release"):
        del blocks, traces
    return out


def _cores():
    """The cores this process may run on: its affinity mask where the
    platform has one, else the machine's count."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


# Files of device_compress_corpus in flight at once, each extracted and
# packed on a thread pool (the native extractor and packer release the
# GIL): one a core the process may run on, and at least two.  Each keeps
# the extractor's own GOP threads, which spread a large file over the
# cores where the window is not full (chip_stages.py window measures both).
EXTRACT_WINDOW = max(2, _cores())
# The input bytes of the files submitted and not yet taken by the main
# thread, at most (a file is admitted alone whatever its size).  A file's
# bins are not known before it is extracted, its bytes are: ~8-16 bins a
# byte, each a 2-byte code in the lane form (gop scope; an 8-byte record
# in the slice scope) while the file extracts and packs, so the files in
# flight hold ~16-32 times this in codes (the 8-byte records that this
# bound was measured with held ~70-130 times it).  On a directory of long HD
# clips (20-33 MB each) 64 MiB keeps two or three extracting, as fast as
# no bound and with a third less peak RSS; a budget under two such files
# runs them one at a time, ~22% slower.  It holds back none of many small
# files (chip_stages.py bigcorpus, window; an H100 machine's 8 cores).
EXTRACT_BYTES = 64 << 20


def _read(x):
    return open(x, "rb").read() if isinstance(x, str) else bytes(x)


def _drop_traces(blocks, traces):
    """blocks with each trace replaced by a placeholder object, and the
    placeholders in traces' order: all that _serialize needs of a file
    once its lanes are packed (the records, and the native buffer that
    holds them, can go)."""
    stub = {id(t): object() for t in traces}
    blocks = [
        (*b[:6], stub[id(b[6])], *b[7:])
        if b[0] == KIND_SLICE and not isinstance(b[6], bytes) else b
        for b in blocks
    ]
    return blocks, list(stub.values())


def _extract_and_pack(data, scope, substream_bins):
    """One file of device_compress_corpus, on its extraction worker:
    extract, pack the lanes into arrays of the file's own (pack_lanes:
    native traces through the native packer, the GIL released; span pack)
    and let the traces go here (span extract_release), so that a native
    extraction's buffer closes on this thread as soon as the pack ends.
    Returns (data, None) for a file without traces, which the main thread
    compresses on the host; else (None, ((p1, bitw, lens), (sps, pps,
    blocks, placeholders, spans)))."""
    # the lane form in the gop scope (see extract_traces)
    sps, pps, blocks, traces, _ = extract_traces(data, scope=scope,
                                                 want_slots=False)
    if not traces:
        return data, None
    with span("pack"):
        p1, bitw, lens, spans = pack_lanes(traces, substream_bins)
    blocks, stubs = _drop_traces(blocks, traces)
    with span("extract_release"):
        del traces
    return None, ((p1, bitw, lens), (sps, pps, blocks, stubs, spans))


def device_compress_corpus(inputs, scope="gop", substream_bins=4096,
                           device=None, stats=None):
    """Batch-directory device compression: compress many files through ONE
    streaming device pipeline instead of per-file device_compress calls.

    Files are extracted and packed on a thread pool, each on its worker
    (_extract_and_pack: the file's lanes in arrays of its own, its traces
    let go there), up to EXTRACT_WINDOW files and EXTRACT_BYTES input
    bytes in flight, submitted and taken in one order (largest first), so
    the batcher's append order, and with it the dispatch groups, do not
    depend on the window.  The main thread copies each file's rows into
    the cross-file batcher's dispatch group (ops/lane_coder.StreamingBatcher
    .add, which splits a file across groups and keeps a group to one
    upload form); full groups launch as they fill, and each group is read
    back before the next launches.  A file's container is serialised as
    soon as the rows of its lanes are back, each envelope cut by offset
    from its group's bytes, and a group's bytes are let go once every file
    in it is serialised.  Output containers are byte-identical to
    device_compress(f, scope=..., substream_bins=...) per file.

    inputs: list of paths or bytes.  Returns list of container bytes, in
    input order.  stats (optional dict) receives the call's spans and
    counters (spans.KEYS; seconds on the host clock, summed over the
    threads): 'dispatches' and 'bins'; the workers' extraction (extract_s,
    its parts extract_native_s, extract_walk_s, extract_stitch_s,
    extract_py_s, the native GOP jobs' gop_*, and the traces' release,
    extract_release_s) and lane pack (pack_s); on the main thread, the
    wait on each file's extraction (wait_s), the copy of rows into the
    groups (copy_s), dispatch_s and upload_s, the read-back (collect_s),
    envelope_s and serialise_s.  substream_bins=0 raises ValueError: the
    corpus path is lane-only, as in the JAX package.  An exception in a
    file's extraction or pack propagates as raised, after the extractions
    not yet started are cancelled and the group being filled is given
    back."""
    dev = resolve_device(device)
    if not substream_bins:
        raise ValueError(
            "device_compress_corpus is lane-parallel only: give "
            "substream_bins > 0, or call device_compress per file for "
            "substream_bins=0"
        )
    with call("device_compress_corpus", stats):
        return _compress_corpus(inputs, scope, substream_bins, dev)


def _compress_corpus(inputs, scope, substream_bins, dev):
    scope_id = SCOPE_SLICE if scope == "slice" else SCOPE_GOP
    sizes = [os.path.getsize(x) if isinstance(x, str) else len(x)
             for x in inputs]
    # biggest files first: their uploads start while the remaining files
    # extract on the host CPU
    todo = collections.deque(sorted(range(len(inputs)),
                                    key=lambda i: -sizes[i]))

    this_call = current()

    def extract(i):
        with bind(this_call, i):
            return _extract_and_pack(_read(inputs[i]), scope, substream_bins)

    outs = [None] * len(inputs)
    waiting = collections.deque()  # copied files: (index, rows, meta)
    batcher = StreamingBatcher(dev)

    def serialise_ready():
        got = batcher.streams
        while waiting and waiting[0][1][1] <= got.end:
            idx, (lo, _), (sps, pps, blocks, stubs, spans) = waiting.popleft()
            envs = [got.envelope(lo + a, lo + b) for a, b in spans]
            outs[idx] = _serialize(scope_id, sps, pps, blocks, stubs, envs,
                                   substream_bins)
        got.trim(waiting[0][1][0] if waiting else got.end)

    ahead = collections.deque()  # (input index, future), in order
    held = 0  # input bytes submitted and not yet taken
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=EXTRACT_WINDOW)

    def submit():
        nonlocal held
        while todo and len(ahead) < EXTRACT_WINDOW and (
                not held or held + sizes[todo[0]] <= EXTRACT_BYTES):
            i = todo.popleft()
            held += sizes[i]
            ahead.append((i, pool.submit(extract, i)))

    try:
        submit()
        while ahead:
            idx, fut = ahead.popleft()
            submit()
            try:
                with span("wait", idx):
                    data, packed = fut.result()
            finally:
                # the future holds the packed rows, or the exception, whose
                # traceback holds this frame
                del fut
            held -= sizes[idx]
            submit()
            if packed is None:
                outs[idx] = compress(data, scope=scope,
                                     substream_bins=substream_bins)
            else:
                rows, meta = packed
                del packed
                waiting.append((idx, batcher.add(*rows), meta))
                del rows
            serialise_ready()
        batcher.finish()
        serialise_ready()
    except BaseException:
        batcher.close()
        ahead.clear()  # the packed files' rows
        raise
    finally:
        pool.shutdown(cancel_futures=True)
    return outs


def multichip_step(slots, bits, pcabs, limits, valid, cls=None, device=None,
                   group=None):
    """One sharded est step with the cross-rank billing collective: the
    SPMD function every rank of the torch.distributed group calls with the
    WHOLE [S, T] problem (numpy).  The rank takes its contiguous
    S / world rows, runs the est stage on its device (None: the rank's own
    card, ranks.rank_device; the est_encode kernel on a card, its plain
    version on the CPU) and returns (out, lens, total): its rows in
    ops/estimator.encode_slices' form, and total = all_reduce(sum(lens))
    over the group, the same int on every rank.

    The reduction's operand is one int64: on the card when the group's
    backend is nccl, on the CPU (gloo) otherwise."""
    dev = rank_device(device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    S = np.shape(slots)[0]
    if S % world:
        raise ValueError(f"S={S} traces do not divide over {world} ranks")
    if cls is None:
        cls = np.zeros_like(limits)
    lo, hi = rank * (S // world), (rank + 1) * (S // world)
    prob = from_numpy_traces(
        *(np.asarray(a)[lo:hi] for a in (slots, bits, pcabs, limits, valid,
                                         cls)), dev)
    out, lens = pack_stream_rows(est_collect(*est_encode(*prob)))
    total = torch.tensor([int(lens.sum())], dtype=torch.int64,
                         device=collective_device(group, dev))
    dist.all_reduce(total, group=group)
    return out, lens, int(total)


# ------------------------------------------------------------------------
# Decode direction: device_decompress, the mirror of device_compress.
#
# The entropy decode of a recoded container is a serial recurrence through
# the MODEL (each bin's probability depends on every previously decoded
# bin via the parser state), so the probability schedule is derived on the
# host.  The pipeline runs three phases:
#   A  host model pass: decompress the container with a RECORDING model
#      that captures each scope unit's per-bin probability schedule
#      (record_units),
#   B  device entropy decode: the sub-streams of every unit decode
#      lane-parallel in one launch of ops/lane_decoder.lane_decode, the
#      exact integer mirror of the host range decoder (decode_units),
#   C  host assembly: the container is decoded AGAIN with the
#      device-produced bins feeding the parser + CABAC re-encoder (no
#      model arithmetic at all in this pass), producing the output bytes
#      (assemble_units).
# The returned file is built from device-decoded bins end to end and is
# byte-identical to codec.decompress(blob).  This is a capability and
# verification surface, not the speed path: phase A already contains a
# full host entropy decode (fundamental, not an implementation artifact).


class _RecordingModel(RecodeModel):
    """RecodeModel('decode') that records the (p1, bit) schedule."""

    def __init__(self, data, substream_bins):
        super().__init__("decode", data, substream_bins=substream_bins)
        self.raw = data
        self.rec_p1s = []
        self.rec_bits = []

    def get_bit(self, key, pcab=None):
        self._boundary()
        e, p1, mixctx = self._prob_update(key, pcab)
        bit = self.rc.get(p1)
        self.rec_p1s.append(p1)
        self.rec_bits.append(bit)
        self._update_mix(mixctx, p1, bit)
        self._adapt(key, e, bit)
        return bit


class _FeedModel:
    """Serves pre-decoded bins to the parser; no model arithmetic."""

    def __init__(self, bits):
        self.bits = bits
        self.i = 0

    def get_bit(self, key, pcab=None):
        b = int(self.bits[self.i])
        self.i += 1
        return b

    def get_nnz(self, cat, max_coeff, prior):
        # bit-count mirror of RecodeModel.get_nnz
        v = 0
        for _ in range((max_coeff - 1).bit_length()):
            v = (v << 1) | self.get_bit(None)
        return v + 1


def record_units(blob):
    """Phase A: the host model pass.  Returns (output bytes, units): one
    _RecordingModel per scope unit, in container order, with its probability
    schedule (rec_p1s), the bins the host decoded (rec_bits) and its
    sub-stream bytes."""
    units = []

    def rec_factory(data, B):
        m = _RecordingModel(data, B)
        units.append(m)
        return m

    return decompress(blob, _model_factory=rec_factory), units


def pack_units(units):
    """Every unit's lanes as ONE numpy decode problem: rows are the lanes of
    all units in order, B is the container's substream_bins, or the longest
    unit when it is 0 (a v1 unit is one lane of all its bins).

    Returns (stream, offs, p1u16, lens, spans); spans[i] is the (lo, hi)
    lane range of units[i] (lo == hi for a unit without bins).  A unit with
    fewer sub-streams than its bins need gets empty ones, which decode as
    zero bytes, as the host model reads a corrupted envelope."""
    counts = [len(m.rec_p1s) for m in units]
    B = max((m.B or n for m, n in zip(units, counts)), default=0)
    spans, streams = [], []
    for m, n in zip(units, counts):
        k = -(-n // B) if n else 0
        have = list((m.streams if m.B else [m.raw])[:k])
        streams += have + [b""] * (k - len(have))
        spans.append((len(streams) - k, len(streams)))
    L = len(streams)
    p1u16 = np.zeros((L, -(-max(B, 1) // CHUNK) * CHUNK), np.uint16)
    lens = np.zeros(L, np.int32)
    for m, n, (lo, hi) in zip(units, counts, spans):
        if not n:
            continue
        flat = lane_decoder.to_p1u16(np.asarray(m.rec_p1s, np.int64))
        full = (hi - lo) * B
        if n < full:
            flat = np.pad(flat, (0, full - n))
        p1u16[lo:hi, :B] = flat.reshape(hi - lo, B)
        lens[lo:hi] = B
        lens[hi - 1] = n - (hi - lo - 1) * B
    return (*lane_decoder.pack_streams(streams), p1u16, lens, spans)


def split_unit_bits(bitw, lens, spans):
    """Decoded bit words [L, Bp/32] (numpy) -> each unit's bins as a list
    of Python ints, the lanes' valid bins in order."""
    bits = lane_decoder.unpack_bits(bitw)
    out = []
    for lo, hi in spans:
        rows = [bits[l, : lens[l]] for l in range(lo, hi)]
        out.append(np.concatenate(rows).tolist() if rows else [])
    return out


def decode_units(units, device=None):
    """Phase B: decode every unit's bins on `device` from its sub-stream
    bytes and its recorded probability schedule, all units in one
    lane_decode call.  Returns each unit's bins (a list of ints per
    unit), which equal its rec_bits."""
    dev = resolve_device(device)
    stream, offs, p1u16, lens, spans = pack_units(units)
    prob = lane_decoder.from_numpy_problem(stream, offs, p1u16, lens, dev)
    bitw = lane_decoder.lane_decode(*prob)
    return split_unit_bits(bitw.cpu().numpy(), lens, spans)


def assemble_units(blob, unit_bits):
    """Phase C: decode the container again with the given bins feeding the
    parser and the CABAC re-encoder; any divergence surfaces as a parse or
    size error."""
    it = iter(unit_bits)
    return decompress(blob, _model_factory=lambda data, B: _FeedModel(next(it)))


def device_decompress(blob, device=None):
    """Decompress a container with the entropy decode executed on `device`
    (lane-parallel across sub-streams); output is byte-identical to
    codec.decompress(blob).  Raises if the device decode disagrees with the
    host model pass (it cannot, short of a hardware fault: the kernel is
    the exact integer mirror)."""
    dev = resolve_device(device)
    blob = bytes(blob)
    host_out, units = record_units(blob)
    out = assemble_units(blob, decode_units(units, dev))
    if out != host_out:
        raise RuntimeError("device decode diverged from host model pass")
    return out
