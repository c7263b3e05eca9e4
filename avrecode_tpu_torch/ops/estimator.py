"""Est-on-device recode model + range encoder, plain PyTorch.

Counterpart of avrecode_tpu/ops/estimator_jax.py, with the same function
names.  Given per-trace bin traces (slot, bit, pcab) from the host parser,
the device reproduces the host model arithmetic bit for bit (model v10:
dual-rate counters, 6-input per-class logistic mixer, APM stage) and
range-codes every trace's stream, byte-identical to the host RecodeModel +
RangeEncoder pair.

Every function here is a Python loop over bins, vectorised over the trace
axis S.  It is the plain version of the CUDA kernel csrc/est_encode.cu
(see est_coder.py), which runs the same per-bin step, one thread per trace.

torch defines no int32 overflow, so values are held in int64 tensors; the
coder's uint32 registers carry explicit & 0xFFFFFFFF masks (lane_coder's
encode_step), and the model's signed shifts stay arithmetic shifts on
int64.
"""

import functools

import numpy as np
import torch

from .. import resolve_device
from ..models.h264_model import _apm_row
from ..models.trace import N_CLS  # model.h::K_NCLS
from ._mix_tables import SQUASH, STRETCH12
from .lane_coder import encode_step, flush_state

HALVE_FAST = 0x18  # model v4 fast-counter halving (model.h::kHalveFast)
HIST_MAG = 256  # model v5 last-bit history magnitude (model.h::kHistMag)
HIST2_MAG = 128  # model v7 second-last-bit magnitude (model.h::kHist2Mag)
APM_CELLS = 33  # model v10 APM buckets per class (model.h::kApmCells)
APM_RATE = 6  # model v10 APM adaptation shift (model.h::kApmRate)
APM_HIST = 5  # stage-2 APM history contexts (model.h::kApmHist)
W_CLIP = 1 << 24  # mixer weight clip


@functools.cache
def _tables_np():
    tbl = np.stack([np.asarray(STRETCH12, np.int32),
                    np.asarray(SQUASH, np.int32)], axis=-1)
    return tbl, np.asarray(_apm_row(), np.int32)


def est_tables(device):
    """The model's fixed state as int32 tensors on `device`:
    tbl [4096, 2] (column 0 stretch, column 1 squash) and the identity APM
    row [APM_CELLS] (squash of each bucket's stretch-domain center)."""
    tbl, apm_row = _tables_np()
    dev = torch.device(device)
    return torch.from_numpy(tbl).to(dev), torch.from_numpy(apm_row).to(dev)


def model_probs(slots, bits, pcabs, limits, cls, valid):
    """Adaptive dual-rate estimator + logistic mixer + APM over every trace
    (host-model mirror: model.h::mix_prob/update_mix/adapt, model v10).

    slots/bits/pcabs/valid: integer tensors [S, T]; limits/cls: [S, NS]
    (per-slot halving limit and key class), all on one device.  Bins with
    valid != 1 leave every state untouched.  Returns p1 int32 [S, T],
    0x8000 where valid != 1."""
    dev = slots.device
    S, T = slots.shape
    NS = limits.shape[1]
    tbl, apm_row = est_tables(dev)
    stretch = tbl[:, 0].long()
    squash = tbl[:, 1].long()

    def cols(x):
        return x.long().T.contiguous()

    slots_c, bits_c, pcabs_c = cols(slots), cols(bits), cols(pcabs)
    valid_c = (valid == 1).T.contiguous()
    lim = limits.long().reshape(-1)
    cl = cls.long().reshape(-1)
    rows = torch.arange(S, device=dev)
    ebase, wbase = rows * NS, rows * N_CLS

    # flat per-trace state: est rows [pos, neg, fpos, fneg, last(2=none),
    # last2], mixer weights per class, APM cells per (class, history)
    est = torch.ones((S * NS, 6), dtype=torch.int64, device=dev)
    est[:, 4:] = 2
    w = torch.tensor([24576, 24576, 0, 0, 0, 0], dtype=torch.int64,
                     device=dev).repeat(S * N_CLS, 1)
    apm = apm_row.long().repeat(S * N_CLS * APM_HIST)
    x2 = torch.full((S,), 77, dtype=torch.int64, device=dev)
    p1s = torch.empty((T, S), dtype=torch.int32, device=dev)

    for i in range(T):
        slot, bit, pcab, v = slots_c[i], bits_c[i], pcabs_c[i], valid_c[i]
        eidx = ebase + slot
        e = est[eidx]
        e0, e1, f0, f1, lb, lb2 = e.unbind(1)
        pe = ((e0 << 16) // (e0 + e1)).clamp(1, 0xFFFF)
        pf = ((f0 << 16) // (f0 + f1)).clamp(1, 0xFFFF)
        x0 = stretch[pe >> 4]
        x1 = torch.where(pcab > 0, stretch[pcab >> 4], 0)
        x3 = stretch[pf >> 4]
        x4 = torch.where(lb == 2, 0, torch.where(lb == 1, HIST_MAG, -HIST_MAG))
        x5 = torch.where(lb2 == 2, 0,
                         torch.where(lb2 == 1, HIST2_MAG, -HIST2_MAG))
        xs = torch.stack([x0, x1, x2, x3, x4, x5], dim=1)
        c = cl[eidx]
        widx = wbase + c
        wr = w[widx]
        # >> 6 before the multiply keeps the dot inside int32 on the card
        dot = (((wr >> 6) * xs).sum(dim=1) >> 10).clamp(-2048, 2047)
        pmix = squash[dot + 2048]
        u = stretch[pmix >> 4] + 2048
        j = u >> 7
        frac = u - (j << 7)
        h = torch.where((lb == 2) | (lb2 == 2), 4, lb * 2 + lb2)
        aidx = ((wbase + c) * APM_HIST + h) * APM_CELLS + j
        a0, a1 = apm[aidx], apm[aidx + 1]
        pa = (a0 * (128 - frac) + a1 * frac) >> 7
        pb = ((pmix + pa) >> 1).clamp(1, 65535)
        p1 = squash[stretch[pb >> 4] + 2048]
        tgt = bit << 16
        shift = 7 + APM_RATE
        apm[aidx] = torch.where(v, a0 + (((tgt - a0) * (128 - frac)) >> shift),
                                a0)
        apm[aidx + 1] = torch.where(v, a1 + (((tgt - a1) * frac) >> shift), a1)
        err = (tgt - pmix)[:, None]  # the mixer learns on its pre-APM output
        wn = (wr + ((err * xs) >> 14)).clamp(-W_CLIP, W_CLIP)
        w[widx] = torch.where(v[:, None], wn, wr)
        inc1 = (bit == 1).long()  # index 0 counts ones
        e0n, e1n = e0 + inc1, e1 + (1 - inc1)
        f0n, f1n = f0 + inc1, f1 + (1 - inc1)
        halve = (e0n + e1n) > lim[eidx]
        e0n = torch.where(halve, (e0n + 1) >> 1, e0n)
        e1n = torch.where(halve, (e1n + 1) >> 1, e1n)
        fhalve = (f0n + f1n) > HALVE_FAST
        f0n = torch.where(fhalve, (f0n + 1) >> 1, f0n)
        f1n = torch.where(fhalve, (f1n + 1) >> 1, f1n)
        new = torch.stack([e0n, e1n, f0n, f1n, bit, lb], dim=1)
        est[eidx] = torch.where(v[:, None], new, e)
        p1s[i] = torch.where(v, p1, 0x8000)
    return p1s.T.contiguous()


def range_encode(bits, p1s, valid):
    """Range encoder over every trace -> raw tokens in the kernel's layout.

    bits/p1s/valid: integer tensors [S, T].  Returns int32
    (tok [S, 2T+2], car [S, 2T+2], count [S]): each trace's emitted bytes
    in order, compacted, then the two flush tokens; car[s, k] is the count
    of pending 32-bit carries that land on the byte before token k.
    count includes the flush pair; positions at or past it hold 0.  A bin
    emits at most two renorm bytes (range >= 2^24 before a put, and the
    split keeps it >= 2^8)."""
    dev = bits.device
    S, T = bits.shape
    bits_c = bits.long().T.contiguous()
    p1_c = p1s.long().T.contiguous()
    valid_c = (valid == 1).T.contiguous()
    low = torch.zeros(S, dtype=torch.int64, device=dev)
    pend = torch.zeros_like(low)
    rng = torch.full_like(low, 0xFFFFFFFF)
    tok = torch.empty((T, S), dtype=torch.int64, device=dev)
    car = torch.empty_like(tok)
    for i in range(T):
        low, pend, rng, tok[i], car[i] = encode_step(
            low, pend, rng, bits_c[i], p1_c[i], valid_c[i])
    ftok, fcar = flush_state(low, pend)

    # compact the bin-major candidates (2 per bin) with one scatter; the
    # extra column W absorbs the candidates that were not emitted
    tok, car = tok.T, car.T
    n = (tok >> 16) & 3
    cand_tok = torch.stack([tok & 0xFF, (tok >> 8) & 0xFF], 2).reshape(S, 2 * T)
    cand_car = torch.stack([car, torch.zeros_like(car)], 2).reshape(S, 2 * T)
    emit = torch.stack([n >= 1, n >= 2], 2).reshape(S, 2 * T)
    W = 2 * T + 2
    wpos = torch.where(emit, torch.cumsum(emit, 1) - 1, W)
    out_tok = torch.zeros((S, W + 1), dtype=torch.int64, device=dev)
    out_car = torch.zeros_like(out_tok)
    out_tok.scatter_(1, wpos, cand_tok)
    out_car.scatter_(1, wpos, cand_car)
    n_emit = emit.sum(1, keepdim=True)
    out_tok.scatter_(1, n_emit, (ftok & 0xFF)[:, None])
    out_tok.scatter_(1, n_emit + 1, ((ftok >> 8) & 0xFF)[:, None])
    out_car.scatter_(1, n_emit, fcar[:, None])
    return (out_tok[:, :W].to(torch.int32), out_car[:, :W].to(torch.int32),
            (n_emit[:, 0] + 2).to(torch.int32))


def finalize_streams(tok, car, count):
    """Host side: raw per-trace token segments -> final stream bytes.

    tok/car [S, W], count [S] (numpy or tensors, range_encode's layout;
    columns past max(count) may be cut off).  Folds pending carries
    (chronological ripple through 0xFF runs) and applies the
    flush-truncation rule; mirror of pallas_coder.finalize_streams with one
    segment per trace."""
    tok, car, count = (np.asarray(torch.as_tensor(x).cpu())
                       for x in (tok, car, count))
    out = []
    for s in range(tok.shape[0]):
        raw = tok[s, : count[s]]
        c = car[s, : count[s]]
        val = raw.astype(np.int64)
        if len(val):
            # base-256 addition toward lower indices, vectorised: each pass
            # propagates overflow one position (passes = longest 0xFF run)
            val[:-1] += c[1:]
            while True:
                ov = val >> 8
                if not ov.any():
                    break
                val &= 0xFF
                val[:-1] += ov[1:]
        # truncation: last token satisfying the host flush condition
        nz = np.nonzero((raw != 0xFF) | (c > 0))[0]
        j_last = int(nz[-1]) if len(nz) else 0
        # shortest-terminator strip on resolved bytes (decoder zero-fills)
        out.append(bytes(val[:j_last].astype(np.uint8)).rstrip(b"\x00"))
    return out


def encode_slices(slots, bits, pcabs, limits, valid, cls=None, device=None):
    """Batched est path on `device`: [S, T] arrays (numpy or tensors) ->
    numpy (bytes uint8 [S, W], n_bytes int32 [S]); trace s's stream is
    stream_bytes(bytes[s], n_bytes[s]).

    cls: per-slot key-class ids [S, NS] for the mixer weight context
    (pipeline.pack_traces); None puts every slot in class 0."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(x).to(dev, torch.int64)

    if cls is None:
        cls = np.zeros(np.shape(limits), np.int64)
    slots, bits, pcabs, limits, valid, cls = map(
        t, (slots, bits, pcabs, limits, valid, cls))
    p1s = model_probs(slots, bits, pcabs, limits, cls, valid)
    streams = finalize_streams(*range_encode(bits, p1s, valid))
    n_bytes = np.array([len(b) for b in streams], np.int32)
    out = np.zeros((len(streams), max(n_bytes, default=0)), np.uint8)
    for s, b in enumerate(streams):
        out[s, : len(b)] = np.frombuffer(b, np.uint8)
    return out, n_bytes


def stream_bytes(out_row, n_bytes):
    """Host side: one batched row -> the trace's stream bytes."""
    return bytes(np.asarray(out_row, np.uint8)[: int(n_bytes)])
