"""Est-on-device entropy stage: the adaptive model and the range coder run
on the device, one serial trace per warp (PyTorch + CUDA).

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

The TPU module's GROUP = 16 and its power-of-two rounding of T and NS are
VMEM and compile-shape workarounds and have no counterpart here: groups are
cut by a bins budget, each padded to its own longest trace.
"""

import functools

import numpy as np
import torch

from .. import resolve_device
from ._mix_tables import STRETCH12
from .estimator import (APM_CELLS, APM_HIST, HALVE_FAST, N_CLS, est_tables,
                        finalize_streams, model_probs, range_encode)
from .lane_coder import _upload

GROUP_BINS = 1 << 27  # rows x T per launch, as the lane path's group
# keeps the counters' << 16 inside int32 on the card, and a counter inside
# the 15 bits the kernel's packed estimator row gives it
MAX_LIMIT = 0x7FFF

# The kernel's shared-memory layout in bytes; csrc/est_encode.cu holds the
# same numbers and its launcher refuses a size that disagrees with them.
SMEM_BLOCK_MAX = 227 * 1024  # dynamic shared memory a block may ask for
SMEM_SM = 228 * 1024  # shared memory of one SM
SMEM_BLOCK_RESERVED = 1024  # what the card keeps of it for each block
TABLE_BYTES = 4096 * 2 + 4096 * 2 + 1024 * 2  # stretch, squash, fast stretch
WARP_FIXED_BYTES = (32 * 16  # one tile of per-bin entries
                    + N_CLS * 8 * 4  # mixer weights, 8 int32 a class
                    + -(-N_CLS * APM_HIST * APM_CELLS * 2 // 16) * 16)  # APM
MAX_WARPS = 8


def rows_bytes(NS):
    """Bytes of one trace's NS packed estimator rows (8 bytes each),
    rounded up to 16."""
    return -(-NS * 8 // 16) * 16


def est_launch_plan(NS):
    """How the kernel is launched for NS slots a trace: (warps a block,
    estimator rows in shared memory?, dynamic shared memory in bytes).

    A warp codes one trace.  Its rows go to shared memory when a block of
    one warp can hold them beside the fixed state, to global scratch
    otherwise.  The warp count is the one that puts most traces on an SM
    at once (the smaller count on a tie, for the finer grain)."""
    for rows_shared in (True, False):
        per_warp = WARP_FIXED_BYTES + (rows_bytes(NS) if rows_shared else 0)
        best = None
        for warps in range(1, MAX_WARPS + 1):
            smem = TABLE_BYTES + warps * per_warp
            if smem > SMEM_BLOCK_MAX:
                break
            on_sm = SMEM_SM // (smem + SMEM_BLOCK_RESERVED) * warps
            if best is None or on_sm > best[0]:
                best = (on_sm, warps, smem)
        if best is not None:
            return best[1], rows_shared, best[2]
    raise AssertionError("the fixed state of one warp fits a block")


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


def _launch(slots, bits, pcabs, limits, valid, cls, tok, car, count):
    """Launch the CUDA kernel on a checked problem (S >= 1) into zeroed
    tok/car [S, 2T+2] and count [S]; raises if it cannot build or launch."""
    from ._build import load

    lib = load()
    dev = slots.device
    S, T = slots.shape
    NS = limits.shape[1]
    tbl, apm_row, pf_tab = _kernel_tables(dev)
    warps, rows_shared, smem = est_launch_plan(NS)
    # estimator rows that shared memory cannot hold, initialised by the kernel
    rows = torch.empty((0 if rows_shared else S, NS), dtype=torch.int64,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.est_encode_launch(
            slots.data_ptr(), bits.data_ptr(), pcabs.data_ptr(),
            valid.data_ptr(), limits.data_ptr(), cls.data_ptr(),
            tbl.data_ptr(), apm_row.data_ptr(), pf_tab.data_ptr(),
            tok.data_ptr(), car.data_ptr(), count.data_ptr(),
            rows.data_ptr(), S, T, NS, warps, int(rows_shared), smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"est_encode kernel launch failed: cudaError {err} "
            f"({lib.kernel_error_string(err).decode()})"
        )


def pack_rows(traces, S, T, NS):
    """Traces -> the est problem as numpy int32 arrays (slots, bits, pcabs,
    limits, valid, cls): rows [S, T] / [S, NS], row i holding traces[i];
    padding is invalid bins and slots with the default halving limit."""
    slots = np.zeros((S, T), np.int32)
    bits = np.zeros((S, T), np.int32)
    pcabs = np.zeros((S, T), np.int32)
    valid = np.zeros((S, T), np.int32)
    limits = np.full((S, NS), 0x60, np.int32)
    cls = np.zeros((S, NS), np.int32)
    for i, t in enumerate(traces):
        k = len(t)
        slots[i, :k] = t.slots
        bits[i, :k] = t.bits
        pcabs[i, :k] = t.pcabs
        valid[i, :k] = 1
        limits[i, : len(t.limits)] = t.limits
        cls[i, : len(t.cls)] = t.cls
    return slots, bits, pcabs, limits, valid, cls


def from_numpy_traces(slots, bits, pcabs, limits, valid, cls, device):
    """Numpy est problem (pack_rows / pipeline.pack_traces output) -> the
    port's contiguous int32 tensors on `device`."""
    dev = torch.device(device)
    return tuple(_upload(np.asarray(a, np.int32), dev)
                 for a in (slots, bits, pcabs, limits, valid, cls))


def encode_traces_est(traces, device=None):
    """Device entropy stage for substream_bins=0: traces -> per-trace
    stream bytes, byte-identical to RecodeModel(...).finish().

    Traces are sorted by length and cut into groups of at most GROUP_BINS
    padded bins, each padded to its own longest trace and slot table.
    Every group is launched before any is read back; the read-back is cut
    to the group's longest token segment."""
    dev = resolve_device(device)
    order = sorted(range(len(traces)), key=lambda i: len(traces[i]))
    groups, grp = [], []
    for i in order:
        if grp and (len(grp) + 1) * max(len(traces[i]), 1) > GROUP_BINS:
            groups.append(grp)
            grp = []
        grp.append(i)
    if grp:
        groups.append(grp)
    pending = []
    for grp in groups:
        ts = [traces[i] for i in grp]
        T = max(max(len(t) for t in ts), 1)
        NS = max(max(len(t.limits) for t in ts), 1)
        prob = from_numpy_traces(*pack_rows(ts, len(ts), T, NS), dev)
        pending.append((grp, est_encode(*prob)))
    streams = [None] * len(traces)
    for grp, (tok, car, count) in pending:
        count = count.cpu()
        M = int(count.max())
        for i, s in zip(grp, finalize_streams(tok[:, :M], car[:, :M], count)):
            streams[i] = s
    return streams
