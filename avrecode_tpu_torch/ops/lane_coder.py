"""Lane-parallel, estimator-free device entropy coder (PyTorch + CUDA).

Counterpart of avrecode_tpu/ops/lane_coder.py, with the same function names
and token semantics.  Trace records carry the exact per-bin model
probability p1, and container v2 resets the coder every B bins, so a trace
splits into ceil(T/B) independent sub-streams ("lanes"), each a bare serial
range-coder recurrence over (bit, p1).

Forms of the per-bin step, all byte-identical:

  * lane_encode        kernel wrapper: the CUDA kernel csrc/lane_encode.cu,
                       which replaces avrecode_tpu/ops/lane_coder.py::
                       _lane_kernel (Pallas), for CUDA tensors; the plain
                       version for CPU tensors
  * lane_encode_plain  a loop over bins, vectorised over lanes (mirror of
                       the JAX lane_encode_scan)
  * the host encoders  ops/rangecoder.py / host/src/rangecoder.h

Each bin emits <= 2 renorm bytes as tok = byte0 | byte1 << 8 | n << 16; car
is the count of pending 32-bit carries attached to byte0.  finalize_device
(or the numpy finalize_lanes) resolves carries (base-256 ripple) and
applies the host flush-truncation and shortest-terminator rules.

The main path does both in one launch: lane_encode_streams (the CUDA kernel
csrc/lane_streams.cu, which replaces the JAX package's _lane_pipeline_jit =
_lane_kernel + _finalize_device) goes from the lane problem straight to
every lane's stream bytes; lane_encode_streams_plain = finalize_device of
lane_encode_plain is its plain version.  Around it, LaneBatcher packs
each file's lanes straight into a dispatch group's reused pinned staging
buffer (the native packer writes at the group's fill row), or copies in
rows packed elsewhere (the corpus driver's workers), dispatch_group
uploads the group from there and launches without a host sync, and
collect_groups reads back the lengths first and then only the columns that
hold stream bytes, one bytes object a group, from which GroupStreams cuts
the envelopes by offset.  lane_streams_device_compact takes numpy rows
through a LaneBatcher of its own and gives per-lane bytes (lane_collect).

The lane problem comes in two upload forms, as in the JAX package:
  index form  uint8 [L, 3 * Bp / 2]: two 12-bit squash-table indices in three
              bytes (pack_p1_idx), 1.5 B a bin; the card takes p1 back from
              the table.  lane_encode_streams_idx (the same kernel, reading
              indices; replaces _lane_pipeline_idx_jit) codes it.
  u16 form    uint16 [L, Bp]: p1 itself, 2 B a bin; lane_encode_streams.
The packer picks the form (pack_lanes): the index form where every valid
bin's p1 lies in the squash table's image, which holds for every trace the
native recorder makes, the u16 form otherwise.  A dispatch group holds
rows of one form and is coded by that form's kernel.

torch defines no int32 overflow, so the plain version holds uint32 values
in int64 tensors with explicit & 0xFFFFFFFF masks; a plain compare is then
the unsigned compare the JAX version builds from a sign flip.
"""

import bisect
import functools
import threading

import numpy as np
import torch

from .. import resolve_device
from ..host import native
from ..models.h264_model import _make_envelope
from ..parallel.mesh import as_mesh, run_sharded
from ..spans import count, span
from ._mix_tables import SQUASH

TOP = 1 << 24
CHUNK = 256  # bin-axis padding: the packers store bits as 32-bit words
LANES = 1024  # lane-row unit of the packers' optional lane padding
GROUP_ROWS = 8 * LANES  # lane rows per dispatch group
MAX_B = 1 << 15  # finalize packs carry counts into 16 bits
_M32 = 0xFFFFFFFF


def encode_step(low, pend, rng, bit, p1, v):
    """One range-coder bin on a vector of lanes (exact mirror of
    RangeEncoder.put, with (byte, pending-carry-count) token emission).

    int64 tensors of one shape, low/rng holding uint32 values.
    Returns (low, pend, rng, tok, car):
      tok = byte0 | byte1 << 8 | n_emitted << 16   (n in 0..2; the byte
            fields are filled even when n < 2, as the TPU kernel does)
      car = pending-carry count attached to byte0.
    Lanes with v False keep their state and emit tok = car = 0."""
    r1 = ((rng >> 16) & 0xFFFF) * p1
    low_a = (low + r1) & _M32
    is1 = bit == 1
    low_n = torch.where(is1, low, low_a)
    pend_n = torch.where(is1, pend, pend + (low_a < low))
    rng_n = torch.where(is1, r1, (rng - r1) & _M32)

    do0 = rng_n < TOP
    tok0 = (low_n >> 24) & 0xFF
    car0 = torch.where(do0, pend_n, 0)
    low_n = torch.where(do0, (low_n << 8) & _M32, low_n)
    pend_n = torch.where(do0, 0, pend_n)
    rng_n = torch.where(do0, (rng_n << 8) & _M32, rng_n)

    do1 = rng_n < TOP
    tok1 = (low_n >> 24) & 0xFF
    low_n = torch.where(do1, (low_n << 8) & _M32, low_n)
    rng_n = torch.where(do1, (rng_n << 8) & _M32, rng_n)

    n = do0.long() + do1.long()
    tok = tok0 | (tok1 << 8) | (n << 16)

    low = torch.where(v, low_n, low)
    pend = torch.where(v, pend_n, pend)
    rng = torch.where(v, rng_n, rng)
    tok = torch.where(v, tok, 0)
    car = torch.where(v, car0, 0)
    return low, pend, rng, tok, car


def flush_state(low, pend):
    """Shortest-terminator flush from final lane state (mirror of
    RangeEncoder.finish): round low up to the next 2^24 multiple, then two
    byte shifts.  Returns (ftok = byte0 | byte1 << 8, fcar for byte0)."""
    low_r = (low + (TOP - 1)) & 0xFF000000
    fcar = pend + (low_r < low)
    ftok = ((low_r >> 24) & 0xFF) | (((low_r >> 16) & 0xFF) << 8)
    return ftok, fcar


# ---------------------------------------------------------------------------
# 12-bit probability upload (the JAX package's pack_p1_idx): every p1 the
# native recorder emits is kSquash[dot + 2048] (model.h requantizes the APM
# blend onto the squash grid), so the host ships the 4,096-entry squash
# table's INDEX, two in three bytes (1.5 B a bin against 2), and the card
# takes the exact p1 back from the table.  Any index with SQUASH[i] == p1
# serves: the table flattens into runs of equal values near the rails.


@functools.cache
def _squash_tables():
    """(SQUASH int32 [4096], reverse map uint16 [65536], in-image flags bool
    [65536]), built once.  The reverse map keeps the last index of a run
    of equal values.  p1 = 0 is flagged in the image and maps to index 0,
    for padding; pack_p1_idx refuses it in a valid bin."""
    sq = np.asarray(SQUASH, np.int32)
    rev = np.zeros(1 << 16, np.uint16)
    ok = np.zeros(1 << 16, bool)
    rev[sq] = np.arange(4096, dtype=np.uint16)
    ok[sq] = True
    ok[0] = True
    return sq, rev, ok


def pack_p1_idx(p1u16, lens):
    """uint16 p1 [L, B] (B even) and lens [L] -> (uint8 [L, 3 * B / 2],
    True), or (None, False) where the p1 of a valid bin (bin < lens) lies
    outside the squash table's image: the caller keeps the u16 form.  The
    layout is the JAX package's: two indices in three bytes, the even bin's
    in the low 12 bits.  Unlike the JAX function, p1 = 0 counts as in the
    image only past lens, where it is padding (index 0): in a valid bin it
    must code as 0, not as SQUASH[0] = 22."""
    _, rev, okt = _squash_tables()
    p1u16 = np.asarray(p1u16, np.uint16)
    live = np.arange(p1u16.shape[1])[None, :] < np.asarray(lens)[:, None]
    if not (okt[p1u16] & ((p1u16 != 0) | ~live)).all():
        return None, False
    idx = rev[p1u16]
    ev, od = idx[:, 0::2], idx[:, 1::2]
    L, H = ev.shape
    out = np.empty((L, H, 3), np.uint8)
    out[:, :, 0] = ev & 0xFF
    out[:, :, 1] = (ev >> 8) | ((od & 0xF) << 4)
    out[:, :, 2] = od >> 4
    return out.reshape(L, 3 * H), True


@functools.cache
def _squash_on(dev):
    """SQUASH as a uint16 tensor on `dev` (the kernels' table), made once a
    device."""
    return torch.from_numpy(_squash_tables()[0].astype(np.uint16)).to(dev)


def index_form(p1):
    """Is p1 (numpy or torch) in the index form, uint8 packed indices?"""
    return p1.dtype == (torch.uint8 if isinstance(p1, torch.Tensor)
                        else np.uint8)


def lane_bins(p1):
    """Bins a lane row holds (Bp) in either upload form: uint8 packed
    indices [L, 3 * Bp / 2] or uint16 p1 [L, Bp] (numpy or torch)."""
    w = p1.shape[1]
    return w * 2 // 3 if index_form(p1) else w


def unpack_p1_idx_plain(p1pk):
    """Plain torch version of the unpack: packed indices uint8 [L, 3 * B / 2]
    -> uint16 p1 [L, B] through the squash table (the unpack and take of
    the JAX _lane_pipeline_idx_jit).  Padding (index 0) becomes
    SQUASH[0] = 22, which the coders never read (it lies past lens)."""
    L, W = p1pk.shape
    b = p1pk.to(torch.int64).reshape(L, W // 3, 3)
    ev = b[:, :, 0] | ((b[:, :, 1] & 0xF) << 8)
    od = (b[:, :, 1] >> 4) | (b[:, :, 2] << 4)
    idx = torch.stack([ev, od], dim=-1).reshape(L, -1)
    sq = torch.from_numpy(_squash_tables()[0]).to(p1pk.device)
    return sq[idx].to(torch.uint16)


def unpack_p1_idx(p1pk):
    """Kernel wrapper of the unpack (see unpack_p1_idx_plain): CUDA tensors
    launch the CUDA kernel csrc/p1_idx.cu on the current stream without
    synchronising (raises if it cannot build or launch); CPU tensors run
    unpack_p1_idx_plain.  unpack_p1_idx.launches counts kernel launches.
    The lane path calls it only where collect_groups codes an index-form
    group again (its overflow fallback)."""
    if p1pk.dtype != torch.uint8 or p1pk.dim() != 2 or p1pk.shape[1] % 48:
        raise ValueError(f"packed indices must be uint8 [L, 3 * B / 2] with "
                         f"B a multiple of 32, got {p1pk.dtype} "
                         f"{tuple(p1pk.shape)}")
    if not p1pk.is_contiguous() or p1pk.data_ptr() % 4:
        raise ValueError("packed indices must be contiguous, from a 4-byte "
                         "boundary (the kernel reads them in 4-byte words)")
    dev = p1pk.device
    if dev.type == "cpu":
        return unpack_p1_idx_plain(p1pk)
    if dev.type != "cuda":
        raise ValueError(f"unpack_p1_idx takes cuda or cpu tensors, not {dev}")
    from ._build import load

    lib = load()
    L, W = p1pk.shape
    p1 = torch.empty((L, W * 2 // 3), dtype=torch.uint16, device=dev)
    if L == 0:
        return p1
    with torch.cuda.device(dev):
        err = lib.unpack_p1_idx_launch(
            p1pk.data_ptr(), _squash_on(dev).data_ptr(), p1.data_ptr(),
            L * W // 12, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"unpack_p1_idx kernel launch failed: cudaError {err} "
            f"({lib.kernel_error_string(err).decode()})"
        )
    unpack_p1_idx.launches += 1
    return p1


unpack_p1_idx.launches = 0


def _check_problem(p1, bitw, lens, index=False):
    """The wrapper's contract: the compact lane problem, contiguous, on one
    device, with B a multiple of 32 and at most MAX_B; p1 as uint16 p1
    [L, B], or with index=True as uint8 packed indices [L, 3 * B / 2]."""
    want = torch.uint8 if index else torch.uint16
    if (p1.dtype, bitw.dtype, lens.dtype) != (want, torch.int32, torch.int32):
        raise TypeError(
            f"lane problem must be ({want} p1, int32 bit words, int32 lens), "
            f"got {p1.dtype}, {bitw.dtype}, {lens.dtype}"
        )
    if p1.dim() != 2:
        raise ValueError(f"p1 must be a 2-d array of rows, got "
                         f"{tuple(p1.shape)}")
    L, W = p1.shape
    if index and W % 3:
        raise ValueError(f"packed index rows of {W} bytes are not 3 * B / 2")
    Bp = lane_bins(p1)
    if Bp % 32 or Bp > MAX_B:
        raise ValueError(f"B={Bp} must be a multiple of 32 and <= {MAX_B}")
    if tuple(bitw.shape) != (L, Bp // 32) or tuple(lens.shape) != (L,):
        raise ValueError(
            f"shapes {tuple(p1.shape)}, {tuple(bitw.shape)}, "
            f"{tuple(lens.shape)} are not [L, {'3B/2' if index else 'B'}], "
            f"[L, B/32], [L]"
        )
    if not (p1.is_contiguous() and bitw.is_contiguous()
            and lens.is_contiguous()):
        raise ValueError("lane problem tensors must be contiguous")
    if not p1.device == bitw.device == lens.device:
        raise ValueError("lane problem tensors must share one device")


def lane_encode_plain(p1u16, bitw, lens):
    """Plain torch version of the lane kernel: a Python loop over bins,
    vectorised over lanes (mirror of the JAX lane_encode_scan).

    p1u16 uint16 [L, B], bitw int32 [L, B/32] little-endian bit words,
    lens int32 [L].  Returns int32 (tok [L, B], car [L, B], ftok [L],
    fcar [L])."""
    _check_problem(p1u16, bitw, lens)
    L, Bp = p1u16.shape
    dev = p1u16.device
    p1 = p1u16.to(torch.int64).T.contiguous()
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((bitw.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(L, Bp)
    bits = bits.T.contiguous()
    lens = lens.to(torch.int64)
    low = torch.zeros(L, dtype=torch.int64, device=dev)
    pend = torch.zeros_like(low)
    rng = torch.full_like(low, _M32)
    tok = torch.empty((Bp, L), dtype=torch.int32, device=dev)
    car = torch.empty_like(tok)
    for i in range(Bp):
        low, pend, rng, tok[i], car[i] = encode_step(
            low, pend, rng, bits[i], p1[i], i < lens)
    ftok, fcar = flush_state(low, pend)
    return (tok.T.contiguous(), car.T.contiguous(), ftok.to(torch.int32),
            fcar.to(torch.int32))


def lane_encode(p1u16, bitw, lens):
    """Kernel wrapper: range-code every lane of the compact lane problem.

    CUDA tensors launch the CUDA kernel (built at first use; raises if it
    cannot build or launch), on the current stream without synchronising.
    CPU tensors run lane_encode_plain.  Same contract and outputs as
    lane_encode_plain; lane_encode.launches counts kernel launches."""
    _check_problem(p1u16, bitw, lens)
    dev = p1u16.device
    if dev.type == "cpu":
        return lane_encode_plain(p1u16, bitw, lens)
    if dev.type != "cuda":
        raise ValueError(f"lane_encode takes cuda or cpu tensors, not {dev}")
    if p1u16.data_ptr() % 16:
        raise ValueError("p1u16 must start on a 16-byte boundary (the kernel "
                         "copies it in 16-byte pieces)")
    from ._build import load

    lib = load()
    L, Bp = p1u16.shape
    tok = torch.empty((L, Bp), dtype=torch.int32, device=dev)
    car = torch.empty_like(tok)
    ftok = torch.empty(L, dtype=torch.int32, device=dev)
    fcar = torch.empty_like(ftok)
    if L == 0:
        return tok, car, ftok, fcar
    with torch.cuda.device(dev):
        err = lib.lane_encode_launch(
            p1u16.data_ptr(), bitw.data_ptr(), lens.data_ptr(),
            tok.data_ptr(), car.data_ptr(), ftok.data_ptr(), fcar.data_ptr(),
            L, Bp, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"lane_encode kernel launch failed: cudaError {err} "
            f"({lib.kernel_error_string(err).decode()})"
        )
    lane_encode.launches += 1
    return tok, car, ftok, fcar


lane_encode.launches = 0


# ---------------------------------------------------------------------------
# Host-side finalize: tokens -> stream bytes (vectorized across all lanes)


def finalize_lanes(tok, car, ftok, fcar, lens):
    """Resolve carries + host truncation rules for all lanes at once.

    tok/car: [L, B] int32; ftok/fcar: [L]; lens: [L].
    Returns a list of L bytes objects (byte-identical to RangeEncoder)."""
    tok = np.asarray(tok)
    car = np.asarray(car)
    ftok = np.asarray(ftok)
    fcar = np.asarray(fcar)
    lens = np.asarray(lens)
    L, B = tok.shape
    n = (tok >> 16) & 3

    # candidate timeline per lane: 2 slots per bin + 2 flush slots
    W = 2 * B + 2
    cand_tok = np.zeros((L, W), np.int64)
    cand_tok[:, 0 : 2 * B : 2] = tok & 0xFF
    cand_tok[:, 1 : 2 * B : 2] = (tok >> 8) & 0xFF
    cand_tok[:, 2 * B] = ftok & 0xFF
    cand_tok[:, 2 * B + 1] = (ftok >> 8) & 0xFF
    cand_car = np.zeros((L, W), np.int64)
    cand_car[:, 0 : 2 * B : 2] = car
    cand_car[:, 2 * B] = fcar
    msk = np.zeros((L, W), bool)
    msk[:, 0 : 2 * B : 2] = n >= 1
    msk[:, 1 : 2 * B : 2] = n >= 2
    msk[:, 2 * B :] = True

    counts = msk.sum(axis=1)
    M = int(counts.max()) if L else 0
    pos = np.cumsum(msk, axis=1) - 1
    rows, cols = np.nonzero(msk)
    p = pos[rows, cols]
    val = np.zeros((L, M), np.int64)
    raw = np.full((L, M), 0xFF, np.int64)  # padding: never flushable
    carr = np.zeros((L, M), np.int64)
    val[rows, p] = cand_tok[rows, cols]
    raw[rows, p] = cand_tok[rows, cols]
    carr[rows, p] = cand_car[rows, cols]

    # base-256 carry ripple toward lower indices; pass count = longest
    # 0xFF run anywhere (carries are rare events)
    val[:, :-1] += carr[:, 1:]
    while True:
        ov = val >> 8
        if not ov.any():
            break
        val &= 0xFF
        val[:, :-1] += ov[:, 1:]

    # host flush condition: a byte lands in the output iff a LATER token has
    # byte != 0xFF or a pending carry (the cache/run closes); the final
    # pending token is never emitted -> truncate AT the last flushable index
    flushable = (raw != 0xFF) | (carr > 0)
    j_last = np.where(
        flushable.any(axis=1),
        M - 1 - np.argmax(flushable[:, ::-1], axis=1),
        0,
    )
    # shortest-terminator: strip trailing zeros (decoder zero-fills) — on
    # RESOLVED bytes (carries can create zeros)
    idx = np.arange(M)
    nzmask = (val != 0) & (idx[None, :] < j_last[:, None])
    nbytes = np.where(
        nzmask.any(axis=1), M - np.argmax(nzmask[:, ::-1], axis=1), 0
    )
    u8 = val.astype(np.uint8)
    return [bytes(u8[l, : nbytes[l]]) for l in range(L)]


# ---------------------------------------------------------------------------
# On-device finalize: kernel tokens -> resolved stream bytes on the device,
# so only stream-sized uint8 data (not 8 bytes/bin of tokens) is read back.


def _shift_left(x):
    """x[:, j + 1] at column j; zero in the last column."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def finalize_device(tok, car, ftok, fcar, max_bytes):
    """Vector finalize on [L, B] kernel outputs, on their device (torch
    port of the JAX _finalize_device).

    Compaction is one packed scatter: each emitted byte is a cell
    byte(8) | carry_count(16) | present(1) << 24.  Carry counts fit 16 bits
    because the counter resets at every emission and a lane codes at most
    B <= 2^15 bins.  Writes past max_bytes land in a dump column that is
    dropped, so duplicate indices there are harmless.

    Returns (bytes uint8 [L, M], nbytes int32 [L], overflow bool tensor):
    `overflow` is set when some lane emitted more than M bytes (adversarial
    streams; such a group is finalized exactly on the host).  This is the
    plain version of the finalize that lane_encode_streams fuses into the
    encoder; its ripple loop reads one flag back to the host a pass."""
    L, B = tok.shape
    M = max_bytes
    n = (tok >> 16) & 3
    cum = torch.cumsum(n, dim=1, dtype=torch.int32)
    pos0 = cum - n
    total = cum[:, -1]
    overflow = (total + 2 > M).any()

    dump = M
    pk0 = (tok & 0xFF) | (car << 8) | (1 << 24)
    pk1 = ((tok >> 8) & 0xFF) | (1 << 24)
    w0 = torch.where(n >= 1, pos0.clamp(max=dump), dump)
    w1 = torch.where(n >= 2, (pos0 + 1).clamp(max=dump), dump)
    cells = torch.zeros((L, M + 1), dtype=torch.int32, device=tok.device)
    cells.scatter_(1, torch.cat([w0, w1], dim=1).long(),
                   torch.cat([pk0, pk1], dim=1))
    fw0 = total.clamp(max=dump).long()[:, None]
    fw1 = (total + 1).clamp(max=dump).long()[:, None]
    cells.scatter_(1, fw0, ((ftok & 0xFF) | (fcar << 8) | (1 << 24))[:, None])
    cells.scatter_(1, fw1, (((ftok >> 8) & 0xFF) | (1 << 24))[:, None])
    cells = cells[:, :M]

    present = cells >> 24
    raw = torch.where(present == 1, cells & 0xFF, 0xFF)
    carr = torch.where(present == 1, (cells >> 8) & 0xFFFF, 0)

    # base-256 ripple toward lower indices; iterations = longest 0xFF
    # propagation chain (carries are rare events); each test reads one
    # flag back to the host
    val = raw * present + _shift_left(carr)
    while bool((val >> 8).any()):
        val = (val & 0xFF) + _shift_left(val >> 8)

    # host truncation: output ends AT the last token with byte != 0xFF or a
    # pending carry (exclusive); then strip trailing zeros (decoder
    # zero-fills)
    idx = torch.arange(M, dtype=torch.int32, device=tok.device)[None, :]
    flushable = (raw != 0xFF) | (carr > 0)
    j_last = torch.where(flushable, idx, -1).amax(dim=1).clamp(min=0)
    nz = (val != 0) & (idx < j_last[:, None])
    nbytes = torch.where(nz, idx + 1, 0).amax(dim=1)
    return val.to(torch.uint8), nbytes.to(torch.int32), overflow


def lane_encode_streams_plain(p1u16, bitw, lens, M):
    """Plain torch version of the fused kernel: finalize_device of
    lane_encode_plain's tokens.  Returns (out uint8 [L, M], nbytes int32
    [L], total int32 [L]); see lane_encode_streams."""
    tok, car, ftok, fcar = lane_encode_plain(p1u16, bitw, lens)
    out, nbytes, _ = finalize_device(tok, car, ftok, fcar, M)
    total = ((tok >> 16) & 3).sum(dim=1, dtype=torch.int32) + 2
    return out, nbytes, total


def lane_encode_streams(p1u16, bitw, lens, M):
    """Kernel wrapper: range-code every lane of the compact lane problem
    straight to its stream bytes (encode and finalize in one launch; the
    counterpart of the JAX package's _lane_pipeline_jit).

    M is the byte bound a lane (max_bytes), a multiple of 8.  Returns
      out    uint8 [L, M]  out[l, :nbytes[l]] is lane l's stream, byte for
                           byte finalize_lanes' of lane_encode's tokens;
                           bytes at and past nbytes[l] are unspecified
      nbytes int32 [L]
      total  int32 [L]     bytes lane l emitted, the two flush bytes
                           included.  total[l] > M: the lane ran past the
                           bound, and out[l] and nbytes[l] mean nothing;
                           (total > M).any() is the JAX function's overflow
                           flag, taken on the device without a host sync.

    CUDA tensors launch the CUDA kernel (built at first use; raises if it
    cannot build or launch), on the current stream without synchronising.
    CPU tensors run lane_encode_streams_plain.
    lane_encode_streams.launches counts kernel launches."""
    return _streams(lane_encode_streams, p1u16, bitw, lens, M)


lane_encode_streams.launches = 0


def lane_encode_streams_idx_plain(p1pk, bitw, lens, M):
    """Plain torch version of lane_encode_streams_idx: unpack_p1_idx_plain,
    then lane_encode_streams_plain."""
    return lane_encode_streams_plain(unpack_p1_idx_plain(p1pk), bitw, lens, M)


def lane_encode_streams_idx(p1pk, bitw, lens, M):
    """lane_encode_streams on the index form (the counterpart of the JAX
    package's _lane_pipeline_idx_jit): p1pk uint8 [L, 3 * B / 2] holds two
    12-bit squash-table indices in three bytes (pack_p1_idx), and the
    kernel takes each bin's p1 from the table.  Same outputs and overflow
    rule as lane_encode_streams.  CPU tensors run
    lane_encode_streams_idx_plain.  lane_encode_streams_idx.launches counts
    kernel launches."""
    return _streams(lane_encode_streams_idx, p1pk, bitw, lens, M, index=True)


lane_encode_streams_idx.launches = 0


def _streams(wrapper, p1, bitw, lens, M, index=False):
    """The body of both fused-kernel wrappers; `wrapper` carries the launch
    count."""
    name = wrapper.__name__
    _check_problem(p1, bitw, lens, index)
    if M <= 0 or M % 8:
        raise ValueError(f"M={M} must be a positive multiple of 8 (the "
                         "kernel stores a lane's bytes in 8-byte pieces)")
    dev = p1.device
    if dev.type == "cpu":
        plain = (lane_encode_streams_idx_plain if index
                 else lane_encode_streams_plain)
        return plain(p1, bitw, lens, M)
    if dev.type != "cuda":
        raise ValueError(f"{name} takes cuda or cpu tensors, not {dev}")
    if p1.data_ptr() % 16:
        raise ValueError(f"{name}: p1 must start on a 16-byte boundary (the "
                         "kernel copies it in 16-byte pieces)")
    from ._build import load

    lib = load()
    L = p1.shape[0]
    Bp = lane_bins(p1)
    out = torch.empty((L, M), dtype=torch.uint8, device=dev)
    nbytes = torch.empty(L, dtype=torch.int32, device=dev)
    total = torch.empty_like(nbytes)
    if L == 0:
        return out, nbytes, total
    args = (bitw.data_ptr(), lens.data_ptr(), out.data_ptr(),
            nbytes.data_ptr(), total.data_ptr(), L, Bp, M,
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if index:
            err = lib.lane_encode_streams_idx_launch(
                p1.data_ptr(), _squash_on(dev).data_ptr(), *args)
        else:
            err = lib.lane_encode_streams_launch(p1.data_ptr(), *args)
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.kernel_error_string(err).decode()})"
        )
    wrapper.launches += 1
    return out, nbytes, total


def pack_compact(bitp1, lens, pad_lanes=LANES):
    """Host-side compact packing: int32 (p1 | bit << 16) [L, B] ->
    (uint16 p1, int32 bit-words, int32 lens), lane/bin axes padded to
    (pad_lanes x CHUNK)."""
    bitp1 = np.asarray(bitp1)
    lens = np.asarray(lens, np.int32)
    L, B = bitp1.shape
    Lp = -(-max(L, 1) // pad_lanes) * pad_lanes
    Bp = -(-max(B, 1) // CHUNK) * CHUNK
    if (Lp, Bp) != (L, B):
        bitp1 = np.pad(bitp1, ((0, Lp - L), (0, Bp - B)))
        lens = np.pad(lens, (0, Lp - L))
    p1u16 = (bitp1 & 0xFFFF).astype(np.uint16)
    bitw = np.packbits(
        (bitp1 >> 16).astype(np.uint8), axis=1, bitorder="little"
    ).view(np.int32)
    return p1u16, bitw, lens


def from_numpy_problem(p1, bitw, lens, device):
    """Numpy compact lane problem (the shared packers' output) -> the
    port's tensors on `device`; p1 stays in the index form where it is
    uint8 packed indices and is taken as uint16 p1 otherwise."""
    dev = torch.device(device)
    p1 = np.asarray(p1)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (p1 if index_form(p1) else p1.astype(np.uint16, copy=False),
                  np.asarray(bitw, np.int32), np.asarray(lens, np.int32))
    )


def to_bitp1(p1u16, bitw):
    """Compact lane problem -> the JAX package's packed int32
    (p1 | bit << 16) [L, B] form, as lane_encode_scan takes it."""
    p1 = np.asarray(p1u16).astype(np.int32)
    words = np.ascontiguousarray(np.asarray(bitw, np.int32))
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    return p1 | (bits.astype(np.int32) << 16)


STAGE_BYTES = 32 << 20  # one pinned staging buffer
STAGE_RING = 3  # staging buffers of a process, used in turns


class _Staging:
    """The process's pinned host buffers: a ring of STAGE_RING upload
    buffers of STAGE_BYTES, used in turns, and one read-back buffer that
    grows to the largest read.  They are allocated once (pinning a fresh
    copy of every upload cost more than the copy over the bus).  An upload
    buffer is rewritten only after the copy that last read it has finished:
    each carries the event recorded behind that copy, on whatever stream
    and card it ran."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ring = []  # [pinned uint8 buffer, event of its last copy]
        self.turn = 0
        self.readback = None

    def _next(self):
        """The next upload buffer, free to be written."""
        if len(self.ring) < STAGE_RING:
            self.ring.append(
                [torch.empty(STAGE_BYTES, dtype=torch.uint8).pin_memory(),
                 None])
        slot = self.ring[self.turn % len(self.ring)]
        self.turn += 1
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def upload(self, t, dev):
        """Contiguous CPU tensor -> a new tensor on the card `dev`, in
        pieces of STAGE_BYTES: the host fills one staging buffer while the
        card copies from the one before.  Does not wait for the last
        copies."""
        out = torch.empty(t.shape, dtype=t.dtype, device=dev)
        src = t.reshape(-1).view(torch.uint8)
        dst = out.reshape(-1).view(torch.uint8)
        stream = torch.cuda.current_stream(dev)
        with self.lock:
            for lo in range(0, src.numel(), STAGE_BYTES):
                n = min(STAGE_BYTES, src.numel() - lo)
                slot = self._next()
                slot[0][:n].copy_(src[lo:lo + n])
                dst[lo:lo + n].copy_(slot[0][:n], non_blocking=True)
                slot[1] = torch.cuda.Event()
                slot[1].record(stream)
        return out

    def download(self, t):
        """CUDA tensor -> its bytes on the host (one bytes object), through
        the pinned read-back buffer; waits for the copy."""
        n = t.numel() * t.element_size()
        with self.lock:
            if self.readback is None or self.readback.numel() < n:
                self.readback = torch.empty(
                    1 << max(n - 1, 1).bit_length(),
                    dtype=torch.uint8).pin_memory()
            host = self.readback[:n].view(t.dtype).view(t.shape)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(t.device))
            done.synchronize()
            return host.numpy().tobytes()


_staging = _Staging()


def _upload(a, dev):
    """Host numpy rows -> device tensor; CUDA uploads go through the reused
    pinned staging buffers without waiting for the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return _staging.upload(t, dev)
    return t.to(dev)


def max_bytes(Bp, bits_per_byte=4):
    """Read-back bound M per lane of B bins: B / bits_per_byte + 8 bytes,
    rounded up to 8."""
    return -(-Bp // bits_per_byte // 8) * 8 + 8


GROUP_RING = 2  # group staging buffers a (form, width) of a process
# arrays under this size are copied into a group with the GIL held
# (_Group.put): ~0.1 ms of copying, what taking the GIL back can cost
HOLD_GIL_BYTES = 1 << 20


class _Group:
    """The host rows of one dispatch group in one upload form: p1 (index
    form uint8 [rows, 3 * Bp / 2], u16 form uint16 [rows, Bp]), bitw int32
    [rows, Bp / 32] and lens int32 [rows], as tensors and as numpy views
    of the same memory (`np`), which the packers write into.  `event` is
    the event recorded behind the last host-to-device copy that read them
    (None before the first); `busy` while a caller fills them."""

    def __init__(self, index, Bp, rows, pin):
        dt, w = (torch.uint8, 3 * Bp // 2) if index else (torch.uint16, Bp)
        self.index, self.Bp = index, Bp
        self.p1 = torch.empty((rows, w), dtype=dt, pin_memory=pin)
        self.bitw = torch.empty((rows, Bp // 32), dtype=torch.int32,
                                pin_memory=pin)
        self.lens = torch.empty(rows, dtype=torch.int32, pin_memory=pin)
        self.np = tuple(t.numpy() for t in (self.p1, self.bitw, self.lens))
        self.event = None
        self.busy = True

    def put(self, r0, p1, bitw, lens):
        """Copy numpy rows (p1 in this group's form) in at row r0, an array
        at a time: one under HOLD_GIL_BYTES through memoryviews with the
        GIL held, a larger one by numpy, which lets the GIL go while it
        copies.  (Beside busy threads, taking the GIL back costs more than
        a small copy: a phase-15 corpus pass's ~6,000 small arrays took
        ~0.6 s letting it go against ~0.1 held; held through every copy,
        a pass of long clips, hundreds of MB a file, ran 5-20% slower.  A
        torch copy_ spreads over the intra-op thread pool: ~13 s a
        phase-15 pass.)"""
        for dst, src in zip(self.np, (p1, bitw, lens)):
            rows = dst[r0:r0 + src.shape[0]]
            if src.nbytes < HOLD_GIL_BYTES:
                memoryview(rows).cast("B")[:] = memoryview(
                    np.ascontiguousarray(src, dst.dtype)).cast("B")
            else:
                rows[...] = src


class _GroupRing:
    """The process's group staging buffers, beside _Staging: every lane row
    goes up from a group (the packer writes a whole group's rows in place,
    numpy rows are copied in), so the upload reads them where they lie, and
    a group's buffers are as large as its rows.  _Staging carries the est
    path's and the decoder's uploads: arrays of any size, copied in pieces
    of STAGE_BYTES, so its pinned memory does not grow with them.

    For a CUDA device, pinned groups of `rows` rows a (form, Bp, rows),
    allocated once and reused in turns, up to GROUP_RING of each (more only
    while every one is being filled); a group is handed out again only
    after the copy that last read it has finished.  For the CPU, a fresh
    plain group each time (the same code path, nothing to reuse).  Pinning
    that fails raises."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rings = {}  # (index, Bp, rows) -> [group, ...], least recent first

    def take(self, index, Bp, rows, dev):
        """A group of `rows` rows in the given form, free to be written
        (busy until dispatched or released)."""
        if Bp > MAX_B:
            raise ValueError(f"B={Bp} > {MAX_B} overflows 16-bit carry "
                             "counts")
        if dev.type != "cuda":
            return _Group(index, Bp, rows, pin=False)
        with self.lock:
            ring = self.rings.setdefault((index, Bp, rows), [])
            free = [g for g in ring if not g.busy]
            if len(ring) < GROUP_RING or not free:
                group = _Group(index, Bp, rows, pin=True)
            else:
                group = free[0]
                ring.remove(group)
                group.busy = True
            ring.append(group)
        if group.event is not None:
            group.event.synchronize()
        return group

    def release(self, group):
        with self.lock:
            group.busy = False


_groups = _GroupRing()


def upload_group(group, n, dev):
    """The group's first n rows -> (p1, bitw, lens) on `dev`: one
    non_blocking copy_ an array straight from the group's buffers, no host
    copy between the packer and the bus, no wait for the card.  The event
    recorded behind the copies frees the group for its next fill.  Span
    upload."""
    with span("upload"):
        bufs = (group.p1, group.bitw, group.lens)
        prob = tuple(torch.empty((n, *t.shape[1:]), dtype=t.dtype,
                                 device=dev) for t in bufs)
        for dst, src in zip(prob, bufs):
            dst.copy_(src[:n], non_blocking=True)
        if dev.type == "cuda":
            group.event = torch.cuda.Event()
            group.event.record(torch.cuda.current_stream(dev))
        _groups.release(group)
        return prob


def _launch(n, lens, prob, Bp, bits_per_byte):
    """One launch of the fused kernel of prob's upload form on its first n
    rows: the pending handle (rows, lens, out, nbytes, total, prob)."""
    code = lane_encode_streams_idx if index_form(prob[0]) else (
        lane_encode_streams)
    return (n, lens, *code(*prob, max_bytes(Bp, bits_per_byte)), prob)


def dispatch_group(group, n, dev, bits_per_byte=4):
    """Upload the group's first n rows (upload_group) and code them with
    one launch of the fused kernel of the group's form, on the current
    stream of `dev`, without a host sync.  Returns one pending handle:
    (rows, lens, out, nbytes, total, the group's device inputs), the inputs
    in the form uploaded.  bits_per_byte sets the byte bound a lane
    (max_bytes); a group with a lane past it is coded again by
    collect_groups from the inputs kept in the handle.  Span dispatch
    (the upload's span inside it); counted in stats "dispatches"."""
    count("dispatches")
    with span("dispatch"):
        prob = upload_group(group, n, dev)
        return _launch(n, prob[2], prob, group.Bp, bits_per_byte)


def read_group(n, out, nbytes, total):
    """Read one dispatched group back: its lengths first (the one wait for
    the device), then only the columns that hold stream bytes, in one copy
    through pinned memory.  Returns (nb, w, flat): lane l's stream is
    flat[l * w: l * w + nb[l]], flat a bytes object of the group's own (the
    pinned read-back buffer is rewritten by the next group's read, so
    nothing may keep a view into it); or None when a lane emitted more
    than the byte bound."""
    nb, tot = torch.stack([nbytes[:n], total[:n]]).cpu().numpy()
    if n and tot.max() > out.shape[1]:
        return None
    w = int(nb.max()) if n else 0
    if w == 0:
        flat = b""
    elif out.device.type == "cuda":
        flat = _staging.download(out[:n, :w])
    else:
        flat = out[:n, :w].numpy().tobytes()
    return nb, w, flat


def cut_streams(nb, w, flat):
    """read_group's result -> the lanes' stream bytes."""
    return [flat[l * w: l * w + n] for l, n in enumerate(nb.tolist())]


def collect_groups(pending):
    """Collect phase: read back dispatched lane groups, one (nb, w, flat)
    a group (read_group).

    lane_collect.overflows counts groups in which a lane emitted more than
    the byte bound: such a group is coded again with lane_encode (an
    index-form group's p1 first unpacked on its device by unpack_p1_idx),
    finalized exactly on the host (finalize_lanes), and given in the same
    form, each lane's bytes padded to the longest.  Span collect."""
    with span("collect"):
        return [_collect_group(*handle) for handle in pending]


def _collect_group(n, _, out, nbytes, total, prob):
    got = read_group(n, out, nbytes, total)
    if got is None:
        lane_collect.overflows += 1
        if index_form(prob[0]):
            prob = (unpack_p1_idx(prob[0]), *prob[1:])
        tok, car, ftok, fcar = (t[:n].cpu().numpy()
                                for t in lane_encode(*prob))
        streams = finalize_lanes(tok, car, ftok, fcar,
                                 prob[2][:n].cpu().numpy())
        w = max(map(len, streams), default=0)
        got = (np.array([len(s) for s in streams], np.int32), w,
               b"".join(s.ljust(w, b"\0") for s in streams))
    return got


def lane_collect(pending):
    """Collect phase as stream bytes, a bytes object a lane
    (collect_groups, then cut_streams)."""
    streams = []
    for got in collect_groups(pending):
        streams.extend(cut_streams(*got))
    return streams


lane_collect.overflows = 0


class GroupStreams:
    """The streams of read-back groups (collect_groups' result) over the
    global rows, groups in dispatch order; a lane's bytes are taken by
    offset into its group's flat bytes, with no bytes object a lane.
    Groups are added one at a time as they are read back (add), and
    dropped once no envelope will be cut from them again (trim)."""

    def __init__(self, groups=()):
        self.starts = [0]  # global row of each group's first lane
        self.nbs, self.ws, self.flats = [], [], []
        self.first = 0  # the first group not trimmed
        for got in groups:
            self.add(*got)

    @property
    def end(self):
        """The global row after the last lane read back."""
        return self.starts[-1]

    def add(self, nb, w, flat):
        """Append the next group's read_group result."""
        self.nbs.append(nb.tolist())
        self.ws.append(w)
        self.flats.append(memoryview(flat))
        self.starts.append(self.starts[-1] + len(nb))

    def trim(self, row):
        """Let go of the bytes of every group that ends at or before the
        global row `row`: envelopes are cut only from rows past it."""
        while (self.first < len(self.flats)
               and self.starts[self.first + 1] <= row):
            self.nbs[self.first] = self.flats[self.first] = None
            self.first += 1

    def envelope(self, lo, hi):
        """_make_envelope of the streams of lanes [lo, hi), over memoryview
        slices of the groups' bytes (no bytes object a lane).  Span
        envelope."""
        with span("envelope"):
            g = bisect.bisect_right(self.starts, lo) - 1
            parts = []
            for l in range(lo, hi):
                while l >= self.starts[g + 1]:
                    g += 1
                r = l - self.starts[g]
                w = self.ws[g]
                parts.append(self.flats[g][r * w: r * w + self.nbs[g][r]])
            return _make_envelope(parts)


class LaneBatcher:
    """Lane accumulator over files: files append their lane rows to one
    global row stream, in dispatch groups of `big` rows that launch as they
    fill (dispatch_group), so many small files share a dispatch instead of
    each paying for a tail group.  Row order is append order, so each
    file's lanes occupy one contiguous global range.

    Rows go straight into the group's staging buffer (_GroupRing.take):
    add_traces packs native traces there by native.lane_pack_into at the
    group's fill row; add copies in rows packed elsewhere (the corpus
    driver packs each file on its extraction worker).  A group holds rows
    of one upload form only: a file whose rows come in the other form than
    the rows waiting (the packer gives a file the u16 form where its p1
    leave the squash image) first dispatches those as a group of their
    own.  A file that crosses a group boundary is packed apart and copied
    in pieces.  bits_per_byte sets the groups' byte bound a lane
    (dispatch_group)."""

    def __init__(self, device, big=None, bits_per_byte=4):
        self.dev = resolve_device(device)
        self.big = big or GROUP_ROWS
        self.bits_per_byte = bits_per_byte
        self.group = None  # the group being filled
        self.acc = 0  # its rows filled
        self.index = True  # the form of the next group
        self.pending = []  # dispatched group handles, global row order
        self.rows = 0  # total rows appended

    def _current(self, index, Bp):
        """The group being filled, in the given form and width: a group
        of another dispatches its rows first (or goes back unused)."""
        g = self.group
        if g is not None and (g.index, g.Bp) != (index, Bp):
            if self.acc:
                self._flush()
            else:
                self.close()
        if self.group is None:
            self.group = _groups.take(index, Bp, self.big, self.dev)
            self.index = index
        return self.group

    def _flush(self):
        self.pending.append(dispatch_group(self.group, self.acc, self.dev,
                                           self.bits_per_byte))
        self.group, self.acc = None, 0

    def add(self, p1, bitw, lens):
        """Append one file's numpy rows (p1 in either upload form), copied
        into the groups (span copy); returns (global_lo, global_hi)."""
        index, Bp = index_form(p1), lane_bins(p1)
        n, done = p1.shape[0], 0
        lo = self.rows
        self.rows += n
        while done < n:
            g = self._current(index, Bp)
            k = min(n - done, self.big - self.acc)
            with span("copy"):
                g.put(self.acc, p1[done:done + k], bitw[done:done + k],
                      lens[done:done + k])
            self.acc += k
            done += k
            if self.acc == self.big:
                self._flush()
        return lo, self.rows

    def add_traces(self, traces, B):
        """Append one file's traces cut into lanes of B bins (pack_lanes'
        rows and rule); returns ((global_lo, global_hi), spans), spans[i]
        the lane range of traces[i] within the file.  Native traces that
        fit in the group's free rows are packed straight into them.  Span
        pack, and copy where rows packed apart are copied in."""
        if not native.native_traces(traces):
            with span("pack"):
                p1, bitw, lens, spans = pack_lanes(traces, B)
            return self.add(p1, bitw, lens), spans
        Bp = -(-max(B, 1) // CHUNK) * CHUNK
        L = native.lane_rows(traces, B)
        # LaneTraces pack to the index form always: a group of the other
        # form dispatches first, as when rows of that form are copied in
        lanes = native.lane_form(traces)
        g = self._current(lanes or self.index, Bp)
        r0 = self.acc
        if L > self.big - r0:
            with span("pack"):
                p1, bitw, lens, spans = native.lane_pack(traces, B, Bp)
            return self.add(p1, bitw, lens), spans
        # the other form's pass writes a scratch array of its own
        other = (None if lanes
                 else np.empty((L, Bp), np.uint16) if g.index
                 else np.empty((L, 3 * Bp // 2), np.uint8))
        mine = g.np[0][r0:r0 + L]
        bitw, lens = g.np[1][r0:r0 + L], g.np[2][r0:r0 + L]
        with span("pack"):
            form, spans = native.lane_pack_into(
                traces, B, Bp,
                *((mine, other) if g.index else (other, mine)), bitw, lens)
        if (form == 1) != g.index:
            # rows r0 on stay unclaimed (never dispatched): the file goes
            # in a group of its form, after the rows that wait
            return self.add(other, bitw.copy(), lens.copy()), spans
        lo = self.rows
        self.rows += L
        self.acc += L
        if self.acc == self.big:
            self._flush()
        return (lo, self.rows), spans

    def dispatch(self):
        """Dispatch the rows that wait (an empty group goes back): every
        pending group handle, in row order."""
        if self.acc:
            self._flush()
        self.close()
        return self.pending

    def close(self):
        """Give the group being filled back to the ring, its rows unsent
        (after a failure, or when nothing waits)."""
        if self.group is not None:
            _groups.release(self.group)
            self.group, self.acc = None, 0

    def finish(self):
        """Dispatch the rows that wait, then read every group back:
        GroupStreams over the global rows."""
        return GroupStreams(collect_groups(self.dispatch()))


class StreamingBatcher(LaneBatcher):
    """A LaneBatcher that reads its groups back as it goes: before each
    dispatch, every group dispatched before is read into `streams` (its
    kernel ran while this group filled) and its device tensors let go, so
    at most one dispatched group waits on the card and its memory does not
    grow with the corpus.  The groups, their rows and the bytes read back
    are the LaneBatcher's."""

    def __init__(self, device, big=None):
        super().__init__(device, big)
        self.streams = GroupStreams()

    def _read(self):
        for got in collect_groups(self.pending):
            self.streams.add(*got)
        self.pending = []

    def _flush(self):
        self._read()
        super()._flush()

    def finish(self):
        """Dispatch the rows that wait and read the last group back:
        `streams`, over every row appended."""
        self.dispatch()
        self._read()
        return self.streams


def lane_streams_device_compact(p1, bitw, lens, device=None,
                                bits_per_byte=4):
    """The fused kernel on pre-packed compact arrays in either upload form
    (see pack_lanes) -> list of per-lane stream bytes: the rows copied into
    a LaneBatcher's groups of GROUP_ROWS, each dispatched, then all read
    back (lane_collect)."""
    batcher = LaneBatcher(device, bits_per_byte=bits_per_byte)
    batcher.add(p1, bitw, lens)
    return lane_collect(batcher.dispatch())


def lane_streams_device(bitp1, lens, device=None, bits_per_byte=4):
    """lane_streams_device_compact on the packed int32 (p1 | bit << 16)
    [L, B] form."""
    p1u16, bitw, lens = pack_compact(bitp1, lens, pad_lanes=1)
    return lane_streams_device_compact(p1u16, bitw, lens, device,
                                       bits_per_byte)


# ---------------------------------------------------------------------------
# Trace front end: sub-stream splitting / packing / envelope assembly


def split_lanes(traces, B):
    """Chop each trace into ceil(T/B)-bin sub-streams (>= 1), pack all
    sub-streams of all traces into one [L, B] problem.

    Returns (bitp1 int32 [L, B], lens int32 [L], spans) where spans[i] is
    the (lo, hi) lane range of traces[i]."""
    spans = []
    L = 0
    for t in traces:
        k = max(1, -(-len(t) // B))
        spans.append((L, L + k))
        L += k
    bitp1 = np.zeros((L, B), np.int32)
    lens = np.zeros(L, np.int32)
    for t, (lo, hi) in zip(traces, spans):
        T = len(t)
        if T:
            packed = (
                np.asarray(t.p1s, np.int32)
                | (np.asarray(t.bits, np.int32) << 16)
            )
            full = (hi - lo) * B
            if T < full:
                packed = np.pad(packed, (0, full - T))
            bitp1[lo:hi] = packed.reshape(hi - lo, B)
            lens[lo:hi] = B
            lens[hi - 1] = T - (hi - lo - 1) * B
    return bitp1, lens, spans


def auto_substream_bins(n_bins):
    """Two-tier sub-stream length: short lanes for small workloads (a
    populated device grid beats envelope overhead at small absolute cost),
    long lanes once there is enough work to fill thousands of them."""
    return 2048 if n_bins < (1 << 22) else 16384


def split_lanes_recs(traces, B):
    """Fast path of split_lanes for native traces: build the compact device
    upload (uint16 p1, packed bit words) DIRECTLY from the zero-copy u64
    record views (recs32: lo = slot|bit<<24, hi = pcab|p1<<16), skipping
    the [L, B] int32 intermediate entirely (one pass over the records
    instead of four)."""
    spans = []
    L = 0
    for t in traces:
        k = max(1, -(-len(t) // B))
        spans.append((L, L + k))
        L += k
    Bp = -(-max(B, 1) // CHUNK) * CHUNK
    p1u16 = np.zeros((L, Bp), np.uint16)
    bitu8 = np.zeros((L, Bp), np.uint8)
    lens = np.zeros(L, np.int32)
    for t, (lo, hi) in zip(traces, spans):
        T = len(t)
        if not T:
            continue
        r32 = t.recs32()
        flat_p1 = p1u16[lo:hi].reshape(-1)
        flat_bit = bitu8[lo:hi].reshape(-1)
        if Bp == B:
            np.right_shift(r32[:, 1], 16, out=flat_p1[:T], casting="unsafe")
            np.bitwise_and(r32[:T, 0] >> 24, 1, out=flat_bit[:T],
                           casting="unsafe")
        else:  # B not CHUNK-aligned: scatter each lane row's B bins
            for j in range(hi - lo):
                a, b = j * B, min((j + 1) * B, T)
                row = p1u16[lo + j]
                np.right_shift(r32[a:b, 1], 16, out=row[: b - a],
                               casting="unsafe")
                np.bitwise_and(r32[a:b, 0] >> 24, 1,
                               out=bitu8[lo + j, : b - a], casting="unsafe")
        lens[lo:hi] = B
        lens[hi - 1] = T - (hi - lo - 1) * B
    bitw = np.packbits(bitu8, axis=1, bitorder="little").view(np.int32)
    return p1u16, bitw, lens, spans


def pack_lanes(traces, B):
    """Traces -> compact lane problem (p1, bitw, lens, spans), p1 in the
    index form (uint8 packed squash indices) where every valid bin's p1
    lies in the squash table's image and in the u16 form otherwise, the
    rule of the JAX package's lane dispatch (choose_form).  Native traces go
    through the one-pass native packer (host/native.lane_pack; equal to
    split_lanes_recs and pack_p1_idx, its plain version; LaneTraces from
    their codes, to the same rows), Python-extracted ones through
    split_lanes + pack_compact (no lane padding) and pack_p1_idx."""
    Bp = -(-max(B, 1) // CHUNK) * CHUNK
    if native.native_traces(traces):
        return native.lane_pack(traces, B, Bp)
    bitp1, lens, spans = split_lanes(traces, B)
    p1u16, bitw, lens = pack_compact(bitp1, lens, pad_lanes=1)
    return choose_form(p1u16, lens), bitw, lens, spans


def choose_form(p1u16, lens):
    """The squash-image rule on a u16 lane problem: its index form
    (pack_p1_idx) where every valid bin's p1 lies in the squash table's
    image, else p1u16 itself."""
    p1pk, ok = pack_p1_idx(p1u16, lens)
    return p1pk if ok else p1u16


def encode_traces_lanes(traces, B, device=None, mesh=None):
    """Device entropy stage: traces -> per-trace sub-stream ENVELOPE bytes
    (the v2 container's stream blob for substream_bins=B), byte-identical
    to RecodeModel(..., substream_bins=B).finish(): dispatch_traces_lanes,
    then collect_traces_lanes.

    mesh (parallel/mesh.make_mesh; not together with device; a device is a
    mesh of one) cuts the traces into contiguous shards (mesh.run_sharded):
    every shard is dispatched on its device, then all are collected in
    shard order."""
    parts = run_sharded(
        len(traces), as_mesh(device, mesh),
        lambda lo, hi, dev: dispatch_traces_lanes(traces[lo:hi], B, dev),
        collect_traces_lanes)
    return [e for part in parts for e in part]


def dispatch_traces_lanes(traces, B, device=None):
    """Dispatch half of encode_traces_lanes: the traces' lanes go through a
    LaneBatcher of their own on `device` (native traces packed straight
    into the groups' staging buffers) and every group is launched, without
    a host sync.  Returns (pending group handles, each trace's lane
    range)."""
    batcher = LaneBatcher(device)
    spans = batcher.add_traces(traces, B)[1] if traces else []
    return batcher.dispatch(), spans


def collect_traces_lanes(handle):
    """Collect half of encode_traces_lanes: each group read back once, each
    trace's envelope cut from it by offset."""
    pending, spans = handle
    got = GroupStreams(collect_groups(pending))
    return [got.envelope(lo, hi) for lo, hi in spans]
