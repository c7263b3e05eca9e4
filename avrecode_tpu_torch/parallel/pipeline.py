"""Compression pipeline with the device entropy stage (PyTorch + CUDA).

Counterpart of avrecode_tpu/parallel/pipeline.py:

  host   — container demux + slice parse + trace extraction (the
           native extractor, or the Python reference parser),
  device — substream_bins > 0: the lane-parallel estimator-free coder
           (ops/lane_coder.py) and the on-device finalize;
           substream_bins = 0: the adaptive model and the range coder
           (ops/est_coder.py), one trace per thread.  The CUDA kernel runs
           on a card, the plain torch version on the CPU,
  host   — carry folding (est path), sub-stream envelopes (lane path) and
           the container (v2 for the lane path, v1 for the est path).

device_compress(data, scope=..., substream_bins=B) produces a container
BYTE-IDENTICAL to codec.compress(data, scope=..., substream_bins=B).
"""

import concurrent.futures

import numpy as np

from .. import resolve_device
from ..codec import _scan_blocks, compress, serialize_container
from ..host import native
from ..models.h264_model import _make_envelope
from ..models.trace import N_CLS, TraceModel
from ..ops.est_coder import encode_traces_est, pack_rows
from ..ops.lane_coder import (
    GROUP_ROWS,
    auto_substream_bins,
    encode_traces_lanes,
    lane_collect,
    lane_dispatch_compact,
    pack_lanes,
)
from ..utils.container import KIND_SLICE, SCOPE_GOP, SCOPE_SLICE


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
    1=serial."""
    if use_native is not False and native.available():
        try:
            sps, pps, blocks, traces = native.extract(
                bytes(data), scope, threads=threads, want_slots=want_slots)
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

    return serialize_container(
        scope_id, sps, pps, blocks, None, finisher=finisher,
        substream_bins=substream_bins,
    )


def device_compress(data, scope=None, substream_bins=4096, device=None):
    """Full compression with the device entropy stage on `device`.

    scope: "gop" (default with native extraction; best ratio, GOP-parallel)
    or "slice" (finest parallel grain).

    substream_bins > 0 (or "auto") selects the lane-parallel estimator-free
    coder: the recorded exact per-bin probabilities drive a bare range
    coder, one sub-stream per GPU thread.

    substream_bins=0 selects the est-on-device path: the device runs the
    adaptive model itself (counters, mixer, APM) and the range coder, one
    trace per GPU thread, into a v1 container.

    Output is byte-identical to codec.compress(scope=...,
    substream_bins=...)."""
    dev = resolve_device(device)
    data = bytes(data)
    if scope is None:
        scope = "gop" if native.available() else "slice"
    # the lane coder reads only (bit, p1): skip the slot remap pass, which
    # only the est path (substream_bins=0) needs
    sps, pps, blocks, traces, _ = extract_traces(
        data, scope=scope, want_slots=not substream_bins)
    if substream_bins == "auto":
        substream_bins = auto_substream_bins(sum(len(t) for t in traces))
    if not traces:
        return compress(data, scope=scope, substream_bins=substream_bins)
    if substream_bins:
        streams = encode_traces_lanes(traces, substream_bins, device=dev)
    else:
        streams = encode_traces_est(traces, device=dev)
    scope_id = SCOPE_SLICE if scope == "slice" else SCOPE_GOP
    return _serialize(scope_id, sps, pps, blocks, traces, streams,
                      substream_bins)


class _LaneBatcher:
    """Cross-file lane accumulator: files append their lane rows to one
    global row stream; full `big`-row dispatch groups launch as they fill,
    so many small files share dispatches instead of each paying for a
    tail group.  Row order is append order, so each file's lanes occupy
    one contiguous global range."""

    def __init__(self, dispatch_fn, big):
        self.dispatch = dispatch_fn
        self.big = big
        self.segs = []  # undispatched (p1u16, bitw, lens) row segments
        self.acc = 0
        self.pending = []  # dispatched group handles, global row order
        self.rows = 0  # total rows appended

    def add(self, p1u16, bitw, lens):
        """Append one file's rows; returns (global_lo, global_hi)."""
        lo = self.rows
        self.rows += p1u16.shape[0]
        self.segs.append([p1u16, bitw, lens])
        self.acc += p1u16.shape[0]
        while self.acc >= self.big:
            self._flush(self.big)
        return lo, self.rows

    def _take(self, g):
        """Pop exactly g rows off the segment queue (splitting the last)."""
        parts = [[], [], []]
        need = g
        while need:
            seg = self.segs[0]
            n = seg[0].shape[0]
            if n <= need:
                for k in range(3):
                    parts[k].append(seg[k])
                self.segs.pop(0)
                need -= n
            else:
                for k in range(3):
                    parts[k].append(seg[k][:need])
                    seg[k] = seg[k][need:]
                need = 0
        self.acc -= g
        return (np.concatenate(parts[0]), np.concatenate(parts[1]),
                np.concatenate(parts[2]))

    def _flush(self, g):
        p1u16, bitw, lens = self._take(g)
        self.pending.extend(self.dispatch(p1u16, bitw, lens))

    def finish(self):
        """Dispatch the remainder, then collect -> global stream list."""
        if self.acc:
            self._flush(self.acc)
        return lane_collect(self.pending)


def device_compress_corpus(inputs, scope="gop", substream_bins=4096,
                           device=None, stats=None):
    """Batch-directory device compression: compress many files through ONE
    overlapped device pipeline instead of per-file device_compress calls.

    Per file the host extracts + packs, then APPENDS its lanes to the
    cross-file batcher; full dispatch groups launch as they fill, while a
    worker thread extracts the next file (one-deep prefetch; the native
    extractor releases the GIL).  Output containers are byte-identical to
    device_compress(f, scope=..., substream_bins=...) per file.

    inputs: list of paths or bytes.  Returns list of container bytes.
    stats (optional dict) receives {'dispatches': N, 'bins': M}.
    substream_bins=0 raises ValueError: the corpus path is lane-only, as in
    the JAX package."""
    dev = resolve_device(device)
    if not substream_bins:
        raise ValueError(
            "device_compress_corpus is lane-parallel only: give "
            "substream_bins > 0, or call device_compress per file for "
            "substream_bins=0"
        )
    datas = [
        open(x, "rb").read() if isinstance(x, str) else bytes(x)
        for x in inputs
    ]
    scope_id = SCOPE_SLICE if scope == "slice" else SCOPE_GOP
    # biggest files first: their uploads start while the remaining files
    # extract on the host CPU
    order = sorted(range(len(datas)), key=lambda i: -len(datas[i]))

    def dispatch(p1u16, bitw, lens):
        return lane_dispatch_compact(p1u16, bitw, lens, dev)

    metas_by_idx = [None] * len(datas)
    batcher = _LaneBatcher(dispatch, GROUP_ROWS)
    n_bins = 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        nxt = None
        for k, idx in enumerate(order):
            cur = nxt or pool.submit(
                extract_traces, datas[idx], scope=scope, want_slots=False)
            nxt = (
                pool.submit(extract_traces, datas[order[k + 1]], scope=scope,
                            want_slots=False)
                if k + 1 < len(order) else None
            )
            sps, pps, blocks, traces, _ = cur.result()
            rows = spans = None
            if traces:
                p1u16, bitw, lens, spans = pack_lanes(traces, substream_bins)
                rows = batcher.add(p1u16, bitw, lens)
                n_bins += sum(len(t) for t in traces)
            metas_by_idx[idx] = (sps, pps, blocks, traces, spans, rows)
    # drain all device work
    all_streams = batcher.finish()
    outs = []
    for data, (sps, pps, blocks, traces, spans, rows) in zip(datas,
                                                             metas_by_idx):
        if not traces:
            outs.append(compress(data, scope=scope,
                                 substream_bins=substream_bins))
            continue
        streams = all_streams[rows[0]:rows[1]]
        envs = [_make_envelope(streams[lo:hi]) for lo, hi in spans]
        outs.append(_serialize(scope_id, sps, pps, blocks, traces, envs,
                               substream_bins))
    if stats is not None:
        stats["dispatches"] = len(batcher.pending)
        stats["bins"] = n_bins
    return outs
