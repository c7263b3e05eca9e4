"""Est-on-device entropy stage: the adaptive model and the range coder run
on the device, one serial trace per block of stage warps (PyTorch + CUDA).

Counterpart of avrecode_tpu/ops/pallas_coder.py.  The kernel emits RAW
(byte, carry) tokens, one compacted segment per trace; the host folds the
pending carries and applies the flush-truncation rule (finalize_streams,
defined in estimator.py), giving streams byte-identical to the host
RecodeModel coder.

  * est_encode        kernel wrapper: the CUDA kernel csrc/est_encode.cu,
                      which replaces pallas_coder.py::_kernel (Pallas), for
                      CUDA tensors; est_encode_plain for CPU tensors
  * est_encode_plain  estimator.range_encode(bits, estimator.model_probs(..))
                      (loops over bins, vectorised over traces)
  * est_unpack        kernel wrapper: the CUDA kernel csrc/est_unpack.cu,
                      which replaces no TPU kernel, derives a group's [S, T]
                      rows on the card from the traces' 8-byte records;
                      est_unpack_plain for CPU tensors

The TPU module's GROUP = 16 and its power-of-two rounding of T and NS are
VMEM and compile-shape workarounds and have no counterpart here: groups are
cut by a padded-bins budget (on a card its free memory, card_group_bins),
each padded to its own longest trace.
"""

import functools

import numpy as np
import torch

from .. import resolve_device, spans
from ..parallel.mesh import as_mesh, run_sharded
from ._mix_tables import STRETCH12
from .estimator import (APM_CELLS, APM_HIST, HALVE_FAST, N_CLS, est_tables,
                        finalize_streams, model_probs, range_encode)
from .lane_coder import _upload

GROUP_BINS = 1 << 27  # rows x T a launch on the CPU, as the lane path's group
# keeps the counters' << 16 inside int32 on the card, and a counter inside
# the 15 bits the kernel's packed estimator row gives it
MAX_LIMIT = 0x7FFF

# The kernel's shared-memory layout in bytes; csrc/est_encode.cu holds the
# same numbers and its launcher refuses a size that disagrees with them.
SMEM_BLOCK_MAX = 227 * 1024  # dynamic shared memory a block may ask for
SMEM_SM = 228 * 1024  # shared memory of one SM
SMEM_BLOCK_RESERVED = 1024  # what the card keeps of it for each block
TABLE_BYTES = 4096 * 2 + 4096 * 2 + 1024 * 2  # stretch, squash, fast stretch
STAGE_WARPS = 4  # warps a trace: rows, mixer, APM, coder
RING_TILES = 4  # 32-bin tiles a ring between two stages
TRACE_FIXED_BYTES = (32 * 16  # the rows warp's tile of per-bin entries
                     + N_CLS * 8 * 4  # mixer weights, 8 int32 a class
                     + -(-N_CLS * APM_HIST * APM_CELLS * 2 // 16) * 16  # APM
                     # rings rows -> mixer (32 B a bin), mixer -> APM and
                     # APM -> coder (4 B a bin), each tile's bins, and a
                     # full and an empty mbarrier a tile
                     + RING_TILES * 32 * (32 + 4 + 4)
                     + 3 * RING_TILES * 4 + 3 * RING_TILES * 2 * 8)
MAX_TRACES = 8  # traces a block: 32 warps, so 64 registers a thread at most


def rows_bytes(NS):
    """Bytes of one trace's NS packed estimator rows (8 bytes each),
    rounded up to 16."""
    return -(-NS * 8 // 16) * 16


# The card's bytes a padded bin of a group costs, from the stage's own
# allocations: its 8-byte record (freed after est_unpack), the four int32
# rows est_unpack writes (16), est_encode's int32 tok and car, each
# [S, 2T + 2] (16), and the one-byte masks of _check_problem's range check,
# at most 4 alive at once (4).  The records are gone before tok and car are
# made, so the sum bounds the stage's peak from above.
EST_BIN_BYTES = 8 + 16 + 16 + 4


def card_group_bins(dev):
    """The padded bins the next group may hold on card `dev`: half of its
    free memory over EST_BIN_BYTES.  Free is what the driver reports free
    plus what the caching allocator holds reserved but unallocated; the
    other half is left to the allocator's fragmentation.  Read as each
    group is cut, it leaves out what the groups launched before hold until
    the collect (their tok and car), this shard's and the other shards' on
    the card."""
    free = torch.cuda.mem_get_info(dev)[0]
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return free // 2 // EST_BIN_BYTES


def cut_groups(lengths, budget):
    """Trace indices cut into groups, shortest trace first (traces of one
    length in their order), a group a step: each group calls budget() for
    its padded bins as it is cut, so a caller that launches a group before
    it asks for the next one has that group's memory taken off; a group
    takes the next trace while (traces + 1) x that trace's length stays
    within it, and a trace past the budget is a group alone."""
    order = sorted(range(len(lengths)), key=lengths.__getitem__)
    lo = 0
    while lo < len(order):
        cap, hi = budget(), lo + 1
        while hi < len(order) and \
                (hi - lo + 1) * max(lengths[order[hi]], 1) <= cap:
            hi += 1
        yield order[lo:hi]
        lo = hi


def est_launch_plan(NS):
    """How the kernel is launched for NS slots a trace: (traces a block,
    estimator rows in shared memory?, dynamic shared memory in bytes).

    A trace is coded by STAGE_WARPS warps, one a stage.  Its rows go to
    shared memory when a block of one trace can hold them beside the fixed
    state and rings, to global scratch otherwise.  The trace count is the
    one that puts most traces on an SM at once (the smaller count on a tie,
    for the finer grain)."""
    for rows_shared in (True, False):
        per_trace = TRACE_FIXED_BYTES + (rows_bytes(NS) if rows_shared else 0)
        best = None
        for traces in range(1, MAX_TRACES + 1):
            smem = TABLE_BYTES + traces * per_trace
            if smem > SMEM_BLOCK_MAX:
                break
            on_sm = SMEM_SM // (smem + SMEM_BLOCK_RESERVED) * traces
            if best is None or on_sm > best[0]:
                best = (on_sm, traces, smem)
        if best is not None:
            return best[1], rows_shared, best[2]
    raise AssertionError("the fixed state of one trace fits a block")


@functools.cache
def fast_stretch_table():
    """stretch of the fast counters' probability, indexed f0 | f1 << 5:
    STRETCH12[clamp((f0 << 16) // (f0 + f1), 1, 0xFFFF) >> 4] for counters
    1 <= f0, f1 < 32 (the model keeps f0 + f1 <= HALVE_FAST + 1); 0 where a
    counter is 0, which the model never reaches.  int32 [1024]."""
    if HALVE_FAST + 1 >= 32:
        raise ValueError("the fast counters no longer fit 5 bits each")
    tab = np.zeros(1024, np.int32)
    for f0 in range(1, 32):
        for f1 in range(1, 32):
            pf = min(max((f0 << 16) // (f0 + f1), 1), 0xFFFF)
            tab[f0 | f1 << 5] = STRETCH12[pf >> 4]
    return tab


@functools.cache
def _kernel_tables(dev):
    """The kernel's read-only tables on `dev`: est_tables' pair and the
    fast-counter stretch table."""
    return (*est_tables(dev), torch.from_numpy(fast_stretch_table()).to(dev))


def _check_problem(slots, bits, pcabs, limits, valid, cls):
    """The wrapper's contract: int32 [S, T] bins and [S, NS] slot tables,
    contiguous, on one device, every value in the range the kernel reads
    (one flag read back)."""
    ts = (slots, bits, pcabs, limits, valid, cls)
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError(f"est problem must be int32, got {[t.dtype for t in ts]}")
    if slots.dim() != 2 or limits.dim() != 2:
        raise ValueError("slots must be [S, T] and limits [S, NS]")
    S, T = slots.shape
    NS = limits.shape[1]
    if any(tuple(t.shape) != (S, T) for t in (bits, pcabs, valid)) or \
            tuple(cls.shape) != (S, NS) or limits.shape[0] != S:
        raise ValueError(
            f"shapes {[tuple(t.shape) for t in ts]} are not 4 x [S, T] "
            "(slots, bits, pcabs, valid) and 2 x [S, NS] (limits, cls)"
        )
    if NS < 1:
        raise ValueError("est problem needs NS >= 1 slots")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("est problem tensors must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError("est problem tensors must share one device")
    bad = ((slots < 0) | (slots >= NS) | (pcabs < 0) | (pcabs > 0xFFFF)
           | ((bits != 0) & (bits != 1)) | ((valid != 0) & (valid != 1))).any()
    bad |= ((cls < 0) | (cls >= N_CLS) | (limits < 0) | (limits > MAX_LIMIT)).any()
    if bool(bad):
        raise ValueError(
            f"est problem out of range: need 0 <= slot < NS, 0 <= pcab <= "
            f"0xFFFF, bits and valid in {{0, 1}}, 0 <= cls < N_CLS={N_CLS}, "
            f"0 <= limit <= {MAX_LIMIT:#x}"
        )


def est_encode_plain(slots, bits, pcabs, limits, valid, cls):
    """Plain torch version of the est kernel: the same contract and
    outputs, int32 (tok [S, 2T+2], car [S, 2T+2], count [S]), in
    estimator.range_encode's layout."""
    _check_problem(slots, bits, pcabs, limits, valid, cls)
    return _plain(slots, bits, pcabs, limits, valid, cls)


def _plain(slots, bits, pcabs, limits, valid, cls):
    return range_encode(bits, model_probs(slots, bits, pcabs, limits, cls,
                                          valid), valid)


def est_encode(slots, bits, pcabs, limits, valid, cls):
    """Kernel wrapper: model and range-code every trace of the problem.

    CUDA tensors launch the CUDA kernel (built at first use; raises if it
    cannot build or launch), on the current stream without synchronising
    after the launch.  CPU tensors run est_encode_plain.  Same contract and
    outputs as est_encode_plain; est_encode.launches counts kernel
    launches."""
    dev = slots.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"est_encode takes cuda or cpu tensors, not {dev}")
    _check_problem(slots, bits, pcabs, limits, valid, cls)
    if dev.type == "cpu":
        return _plain(slots, bits, pcabs, limits, valid, cls)
    S, T = slots.shape
    tok = torch.zeros((S, 2 * T + 2), dtype=torch.int32, device=dev)
    car = torch.zeros_like(tok)
    count = torch.zeros(S, dtype=torch.int32, device=dev)
    if S == 0:
        return tok, car, count
    _launch(slots, bits, pcabs, limits, valid, cls, tok, car, count)
    est_encode.launches += 1
    return tok, car, count


est_encode.launches = 0


def _launch(slots, bits, pcabs, limits, valid, cls, tok, car, count,
            waits=None):
    """Launch the CUDA kernel on a checked problem (S >= 1) into zeroed
    tok/car [S, 2T+2] and count [S]; raises if it cannot build or launch.
    waits: None, or an int32 [S, STAGE_WARPS] CUDA tensor that takes, per
    trace and stage, the ring tiles on which the stage found its ring not
    ready (the rows stage a full ring to the mixer, the others an empty
    input ring): the largest count names the stage that sets the pace."""
    from ._build import load

    lib = load()
    dev = slots.device
    S, T = slots.shape
    NS = limits.shape[1]
    if waits is not None and (tuple(waits.shape) != (S, STAGE_WARPS)
                              or waits.dtype != torch.int32
                              or waits.device != dev
                              or not waits.is_contiguous()):
        raise ValueError(f"waits must be int32 [S, {STAGE_WARPS}] on {dev}")
    tbl, apm_row, pf_tab = _kernel_tables(dev)
    traces, rows_shared, smem = est_launch_plan(NS)
    # estimator rows that shared memory cannot hold, initialised by the kernel
    rows = torch.empty((0 if rows_shared else S, NS), dtype=torch.int64,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.est_encode_launch(
            slots.data_ptr(), bits.data_ptr(), pcabs.data_ptr(),
            valid.data_ptr(), limits.data_ptr(), cls.data_ptr(),
            tbl.data_ptr(), apm_row.data_ptr(), pf_tab.data_ptr(),
            tok.data_ptr(), car.data_ptr(), count.data_ptr(),
            rows.data_ptr(), None if waits is None else waits.data_ptr(),
            S, T, NS, traces, int(rows_shared), smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"est_encode kernel launch failed: cudaError {err} "
            f"({lib.kernel_error_string(err).decode()})"
        )


def slot_tables(traces, S, NS):
    """The est problem's per-slot tables as numpy int32 [S, NS] (limits,
    cls), row i holding traces[i]'s; padding slots have the default
    halving limit and class 0."""
    limits = np.full((S, NS), 0x60, np.int32)
    cls = np.zeros((S, NS), np.int32)
    for i, t in enumerate(traces):
        limits[i, : len(t.limits)] = t.limits
        cls[i, : len(t.cls)] = t.cls
    return limits, cls


def pack_rows(traces, S, T, NS):
    """Traces -> the est problem as numpy int32 arrays (slots, bits, pcabs,
    limits, valid, cls): rows [S, T] / [S, NS], row i holding traces[i];
    padding is invalid bins and slots with the default halving limit."""
    slots = np.zeros((S, T), np.int32)
    bits = np.zeros((S, T), np.int32)
    pcabs = np.zeros((S, T), np.int32)
    valid = np.zeros((S, T), np.int32)
    for i, t in enumerate(traces):
        k = len(t)
        slots[i, :k] = t.slots
        bits[i, :k] = t.bits
        pcabs[i, :k] = t.pcabs
        valid[i, :k] = 1
    limits, cls = slot_tables(traces, S, NS)
    return slots, bits, pcabs, limits, valid, cls


def from_numpy_traces(slots, bits, pcabs, limits, valid, cls, device):
    """Numpy est problem (pack_rows / pipeline.pack_traces output) -> the
    port's contiguous int32 tensors on `device`."""
    dev = torch.device(device)
    return tuple(_upload(np.asarray(a, np.int32), dev)
                 for a in (slots, bits, pcabs, limits, valid, cls))


def trace_records(t):
    """A trace's per-bin records as int64 [n] (host/native.py's NativeTrace
    layout: lo32 = slot | bit << 24, hi32 = pcab | p1 << 16): a native
    trace's recs viewed zero-copy; any other trace's (the Python
    extractor's TraceModel) slots, bits and pcabs packed into that layout,
    p1 left 0.  Raises ValueError for a native trace whose slot ids were
    not remapped (extracted with want_slots=False) and for a field that
    does not fit its bits."""
    recs = getattr(t, "recs", None)
    if recs is not None:
        if len(recs) and not len(t.limits):
            raise ValueError(
                "trace extracted with want_slots=False: slot ids were not "
                "remapped, so the est stage cannot code it")
        return recs.view(np.int64)
    slots, bits, pcabs = (np.asarray(a, np.int64)
                          for a in (t.slots, t.bits, t.pcabs))
    if ((slots >> 24) | (bits >> 1) | (pcabs >> 16)).any():
        raise ValueError("est problem out of range: a slot, bit or pcab does "
                         "not fit the 8-byte record")
    return slots | bits << 24 | pcabs << 32


def _check_records(recs, S, T):
    """est_unpack's contract: 1 to S int64 [n_i] tensors, contiguous, on one
    device, n_i <= T."""
    if not 1 <= len(recs) <= S:
        raise ValueError(f"est_unpack takes 1 to S={S} traces, got {len(recs)}")
    if any(r.dtype != torch.int64 or r.dim() != 1 for r in recs):
        raise TypeError("records must be 1-D int64 tensors")
    if any(r.numel() > T for r in recs):
        raise ValueError(f"a trace is longer than T={T}")
    if not all(r.is_contiguous() for r in recs):
        raise ValueError("records must be contiguous")
    if len({r.device for r in recs}) != 1:
        raise ValueError("records must share one device")


def est_unpack_plain(recs, S, T):
    """Plain torch version of the unpack: traces' records (int64 [n_i],
    trace_records' layout) -> the rows (slots, bits, pcabs, valid), int32
    [S, T], that pack_rows gives for the same traces: row i from recs[i],
    zeros past its length and in rows len(recs)..S-1."""
    _check_records(recs, S, T)
    dev = recs[0].device
    slots, bits, pcabs, valid = (
        torch.zeros((S, T), dtype=torch.int32, device=dev) for _ in range(4))
    for i, r in enumerate(recs):
        k = r.numel()
        slots[i, :k] = r & 0xFFFFFF
        bits[i, :k] = (r >> 24) & 1
        pcabs[i, :k] = (r >> 32) & 0xFFFF
        valid[i, :k] = 1
    return slots, bits, pcabs, valid


def est_unpack(recs, S, T):
    """Kernel wrapper of the unpack (see est_unpack_plain): CUDA tensors
    launch the CUDA kernel csrc/est_unpack.cu on the current stream without
    synchronising (raises if it cannot build or launch); CPU tensors run
    est_unpack_plain.  est_unpack.launches counts kernel launches."""
    _check_records(recs, S, T)
    dev = recs[0].device
    if dev.type == "cpu":
        return est_unpack_plain(recs, S, T)
    if dev.type != "cuda":
        raise ValueError(f"est_unpack takes cuda or cpu tensors, not {dev}")
    if any(r.data_ptr() % 8 for r in recs if r.numel()):
        raise ValueError("records must start on an 8-byte boundary")
    rows = tuple(torch.empty((S, T), dtype=torch.int32, device=dev)
                 for _ in range(4))
    if S * T:
        _unpack_launch(record_table(recs), len(recs), rows)
    return rows


def record_table(recs):
    """The unpack kernel's table of checked records (est_unpack): int64
    [n, 2], each trace's device address and length, on their card."""
    return _upload(np.array([[r.data_ptr(), r.numel()] for r in recs],
                            np.int64), recs[0].device)


def _unpack_launch(table, n, rows):
    """Launch csrc/est_unpack.cu on the current stream: the n traces of
    `table` (record_table) into `rows`, four int32 [S, T] CUDA tensors
    (S >= n, S x T >= 1); raises if it cannot build or launch."""
    from ._build import load

    lib = load()
    S, T = rows[0].shape
    dev = rows[0].device
    with torch.cuda.device(dev):
        err = lib.est_unpack_launch(
            table.data_ptr(), n, S, T, *(x.data_ptr() for x in rows),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"est_unpack kernel launch failed: cudaError {err} "
            f"({lib.kernel_error_string(err).decode()})"
        )
    est_unpack.launches += 1


est_unpack.launches = 0


def encode_traces_est(traces, device=None, mesh=None):
    """Device entropy stage for substream_bins=0: traces -> per-trace
    stream bytes, byte-identical to RecodeModel(...).finish().

    Traces are sorted by length and cut into groups (cut_groups) of at most
    card_group_bins padded bins on a card, read as each group is cut,
    GROUP_BINS on the CPU, each padded to its own longest trace and slot
    table.  A group goes to the
    device as its traces' records (trace_records), 8 bytes a bin, and its
    slot tables; est_unpack derives its rows there.
    Every group is launched before any is read back; the read-back is cut
    to the group's longest token segment.

    In a call of an entry each group's records and slot tables on the host
    are span est_pack, on CUDA from the second group on the wait for the
    est kernel before (whose stream and staging buffers the uploads share)
    est_wait, its uploads and unpack est_upload and est_encode (with its
    range check's read-back) est_launch (est_collect adds est_collect and
    est_finalize); the groups (stats "est_launches"), the groups closed
    because the card's budget was reached ("est_memory_cuts", 0 on the
    CPU), traces ("est_traces"; "est_stage_traces" those the stage-warp
    kernel coded, all of them on a card, none on the CPU), padded bins S x T
    ("est_padded_bins") and
    stream bytes out ("est_stored") are counted.

    mesh (parallel/mesh.make_mesh; not together with device; a device is a
    mesh of one) cuts the traces into contiguous shards (mesh.run_sharded),
    each grouped and coded as above on its device, whose spans and counters
    it adds; the shards' groups are dispatched in turns, and all are read
    back afterwards in shard order."""
    parts = run_sharded(
        len(traces), as_mesh(device, mesh),
        lambda lo, hi, dev: _dispatch_est(traces[lo:hi], dev), _collect_est)
    streams = [s for part in parts for s in part]
    spans.count("est_stored", sum(len(s) for s in streams))
    return streams


def _dispatch_est(traces, dev):
    """A shard's groups cut (cut_groups), packed, uploaded, unpacked and
    launched on `dev`, one after another; on a card each group's budget is
    card_group_bins, read after the group before it was launched, and the
    dispatch yields after each launch (run_sharded's turns), so that the
    other shards on the card launch theirs before its next group is cut.
    Returns (number of traces, pending (group's trace indices, est_encode
    result) pairs)."""
    cuda = dev.type == "cuda"
    budget = functools.partial(card_group_bins, dev) if cuda else \
        (lambda: GROUP_BINS)
    pending = []
    for grp in cut_groups([len(t) for t in traces], budget):
        if pending and cuda:
            spans.count("est_memory_cuts")  # the budget closed the last
        ts = [traces[i] for i in grp]
        S = len(ts)
        T = max(max(len(t) for t in ts), 1)
        NS = max(max(len(t.limits) for t in ts), 1)
        with spans.span("est_pack"):
            recs = [trace_records(t) for t in ts]
            tables = slot_tables(ts, S, NS)
        if pending and cuda:
            with spans.span("est_wait"):
                torch.cuda.current_stream(dev).synchronize()
        with spans.span("est_upload"):
            prob = _records_problem(recs, tables, S, T, dev)
        del recs, tables
        with spans.span("est_launch"):
            pending.append((grp, est_encode(*prob)))
        del prob  # the rows go back to the allocator before the next cut
        spans.count("est_launches")
        spans.count("est_traces", S)
        if cuda:  # coded by the stage-warp kernel
            spans.count("est_stage_traces", S)
        spans.count("est_padded_bins", S * T)
        if cuda:
            yield
    return len(traces), pending


def _collect_est(handle):
    """A shard's groups read back and finalized (est_collect), each stream
    in its trace's place."""
    n, pending = handle
    streams = [None] * n
    for grp, raw in pending:
        for i, s in zip(grp, est_collect(*raw)):
            streams[i] = s
    return streams


def _records_problem(recs, tables, S, T, dev):
    """A group's est problem on `dev` from its traces' records (numpy int64,
    trace_records) and slot tables: the records and tables uploaded, the
    rows unpacked by est_unpack -> est_encode's arguments."""
    limits, cls = (_upload(a, dev) for a in tables)
    slots, bits, pcabs, valid = est_unpack(
        [_upload(r, dev) for r in recs], S, T)
    return slots, bits, pcabs, limits, valid, cls


def est_collect(tok, car, count):
    """Read one est_encode result back, cut to its longest token segment,
    and finalize it on the host -> per-trace stream bytes.  In a call of
    an entry the read-back is span est_collect and the finalize
    est_finalize."""
    with spans.span("est_collect"):
        count = count.cpu()
        M = int(count.max()) if count.numel() else 0
        tok, car = tok[:, :M].cpu(), car[:, :M].cpu()
    with spans.span("est_finalize"):
        return finalize_streams(tok, car, count)
