"""Adaptive probability model for the recoded stream.

The successor of the reference's h264_model (recode.cpp:625-1066):
  * estimator = (pos, neg) counters, init (1, 1), halved past a count limit
    (0x60 default, 0x50 for significance-map keys — recode.cpp:1048-1052),
  * probability = pos / (pos + neg) in 16-bit fixed point,
  * model keys are small tuples from the parser (context id + richer
    conditioning: neighbor buckets, bin position, nnz progress).

Differences from the reference (wins):
  * bypass bins (mvd suffixes, level escapes, signs) are modeled too — the
    reference codes them at p=1/2 (recode.cpp:1091-1094); we adapt them,
  * significance runs forced by nnz are fully elided (reference codes them
    with rich contexts but still spends bits),
  * end_of_slice terminates are elided via the stored mb_count.

This Python implementation is the semantics oracle; the device path
(ops/estimator_jax.py) and the C++ host path implement the identical integer
recurrence and are differential-tested against it.

Key -> slot mapping is a deterministic insertion-order dict, mirroring the
reference's dynamically grown std::map (recode.cpp:1064-1065).  Compress and
decompress touch keys in identical order, so the mapping never needs to be
stored in the container.
"""

from ..ops._mix_tables import SQUASH, STRETCH12
from ..ops.rangecoder import RangeDecoder, RangeEncoder

HALVE_DEFAULT = 0x60
HALVE_SIG = 0x50
HALVE_FAST = 0x18  # model v4: fast mixer-input counter
HIST_MAG = 256  # model v5: last-bit history input magnitude
HIST2_MAG = 128  # model v7: second-last-bit input magnitude
APM_CELLS = 33  # model v10: APM buckets per class
APM_RATE = 6    # APM adaptation shift (lab rate sweep: 6 > 5 > 4)
APM_HIST = 5    # stage-2 APM history contexts ({00,01,10,11,none})


def _apm_row():
    """Identity-initialized APM row: squash of each bucket's stretch-domain
    center (mirror of model.h::init_pool)."""
    row = []
    for k in range(APM_CELLS):
        sc = k * 128 - 2048
        sc = -2047 if sc < -2047 else (2047 if sc > 2047 else sc)
        row.append(SQUASH[sc + 2048])
    return row


class RecodeModel:
    """mode='encode' wraps a RangeEncoder; mode='decode' a RangeDecoder.

    substream_bins (container field, v2): when nonzero, the coder (NOT the
    model) is reset every B bins, producing a list of independent
    sub-streams framed in a multi-stream envelope.  The estimator state
    runs across the whole model scope unchanged, so the split costs only
    the per-sub-stream terminator (~1-2 bytes) while making encode
    lane-parallel on the device (each sub-stream is an independent range
    coder given recorded probabilities) — the interleaved-entropy-stream
    design of SURVEY.md §2 (bin-level parallelism)."""

    def __init__(self, mode, data=None, substream_bins=0):
        self.mode = mode
        self.B = substream_bins
        self.cur_bins = 0
        if mode == "encode":
            self.rc = RangeEncoder()
            self.closed = []  # finished sub-stream bytes
        elif self.B:
            self.streams = _parse_envelope(data)
            self.si = 0
            self.rc = RangeDecoder(self.streams[0] if self.streams else b"")
        else:
            self.rc = RangeDecoder(data)
        self.est = {}  # key -> [pos, neg]
        self.wmix = {}  # key class -> [w_est, w_cab, w_bias] (16-frac)
        self.apm = {}  # (key class, history ctx) -> 33-cell APM row (v10)
        self.bill = {}  # key-class -> recoded bits (approx, for the ledger)

    def _boundary(self):
        if not self.B:
            return
        if self.cur_bins == self.B:
            if self.mode == "encode":
                self.closed.append((self.rc, self.rc.finish()))
                self.rc = RangeEncoder()
            else:
                self.si += 1
                # corrupted envelope: fewer sub-streams than the bin count
                # needs — zero-fill (the outer parse rejects it loudly)
                self.rc = RangeDecoder(
                    self.streams[self.si]
                    if self.si < len(self.streams) else b"")
            self.cur_bins = 0
        self.cur_bins += 1

    # -- estimator core --------------------------------------------------
    # Logistic mixing (round-2 model upgrade, exact mirror of
    # host/src/model.h::mix_prob/update_mix): counter estimator and live
    # CABAC prior mixed in the stretch (logit) domain with per-key-class
    # learned weights; all shifts are floor shifts, identical in both
    # languages; tables generated once by tools/gen_mix_tables.py.
    def _prob_update(self, key, pcab):
        e = self.est.get(key)
        if e is None:
            e = self.est[key] = [1, 1, 1, 1, 2, 2]  # slow, fast, last, last2
        pe = (e[0] << 16) // (e[0] + e[1])
        pe = 1 if pe < 1 else (0xFFFF if pe > 0xFFFF else pe)
        pf = (e[2] << 16) // (e[2] + e[3])
        pf = 1 if pf < 1 else (0xFFFF if pf > 0xFFFF else pf)
        x0 = STRETCH12[pe >> 4]
        x1 = STRETCH12[pcab >> 4] if pcab else 0
        x3 = STRETCH12[pf >> 4]
        x4 = 0 if e[4] == 2 else (HIST_MAG if e[4] else -HIST_MAG)
        x5 = 0 if e[5] == 2 else (HIST2_MAG if e[5] else -HIST2_MAG)
        w = self.wmix.get(key[0])
        if w is None:
            w = self.wmix[key[0]] = [24576, 24576, 0, 0, 0, 0]  # 0.375 16-frac
        dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77
               + (w[3] >> 6) * x3 + (w[4] >> 6) * x4
               + (w[5] >> 6) * x5) >> 10
        dot = -2048 if dot < -2048 else (2047 if dot > 2047 else dot)
        # model v10: APM/SSE stage (mirror of model.h::mix_prob) — blend
        # the mixer output with a secondary map keyed on (class, 2-bit key
        # history, stretch bucket), then requantize onto the squash grid
        # so every emitted p1 stays in the squash image (12-bit device
        # transfer invariant)
        pmix = SQUASH[dot + 2048]
        u = STRETCH12[pmix >> 4] + 2048
        j = u >> 7
        frac = u - (j << 7)
        h = 4 if (e[4] == 2 or e[5] == 2) else e[4] * 2 + e[5]
        a = self.apm.get((key[0], h))
        if a is None:
            a = self.apm[(key[0], h)] = _apm_row()
        pa = (a[j] * (128 - frac) + a[j + 1] * frac) >> 7
        pb = (pmix + pa) >> 1
        pb = 1 if pb < 1 else (65535 if pb > 65535 else pb)
        p1 = SQUASH[STRETCH12[pb >> 4] + 2048]
        return e, p1, (w, x0, x1, x3, x4, x5, pmix, a, j, frac)

    @staticmethod
    def _update_mix(mixctx, p1, bit):
        w, x0, x1, x3, x4, x5, pmix, a, j, frac = mixctx
        tgt = bit << 16
        a[j] += ((tgt - a[j]) * (128 - frac)) >> (7 + APM_RATE)
        a[j + 1] += ((tgt - a[j + 1]) * frac) >> (7 + APM_RATE)
        err = tgt - pmix  # the mixer learns on its own pre-APM output
        for k, x in ((0, x0), (1, x1), (2, 77), (3, x3), (4, x4), (5, x5)):
            wn = w[k] + ((err * x) >> 14)
            w[k] = -(1 << 24) if wn < -(1 << 24) else (
                (1 << 24) if wn > (1 << 24) else wn)

    def _adapt(self, key, e, bit):
        e[5] = e[4]  # 2-bit history register (model v7)
        e[4] = bit  # history input (model v5)
        e[bit ^ 1] += 1  # index 0 counts ones, index 1 counts zeros
        e[2 + (bit ^ 1)] += 1  # fast counter (model v4)
        limit = HALVE_SIG if key[0] == "sig" else HALVE_DEFAULT
        if e[0] + e[1] > limit:
            e[0] = (e[0] + 1) >> 1
            e[1] = (e[1] + 1) >> 1
        if e[2] + e[3] > HALVE_FAST:
            e[2] = (e[2] + 1) >> 1
            e[3] = (e[3] + 1) >> 1

    def put_bit(self, key, bit, pcab=None):
        self._boundary()
        e, p1, mixctx = self._prob_update(key, pcab)
        n0 = len(self.rc.out)
        self.rc.put(bit, p1)
        cls = key[0]
        self.bill[cls] = self.bill.get(cls, 0) + (len(self.rc.out) - n0) * 8
        self._update_mix(mixctx, p1, bit)
        self._adapt(key, e, bit)

    def get_bit(self, key, pcab=None):
        self._boundary()
        e, p1, mixctx = self._prob_update(key, pcab)
        bit = self.rc.get(p1)
        self._update_mix(mixctx, p1, bit)
        self._adapt(key, e, bit)
        return bit

    # -- out-of-band num_nonzeros (reference C9) ------------------------
    def _nnz_bits(self, max_coeff):
        return (max_coeff - 1).bit_length()

    def put_nnz(self, nnz, cat, max_coeff, prior):
        v = nnz - 1  # cbf/cbp guarantees >= 1
        nb = self._nnz_bits(max_coeff)
        prefix = 0
        pb = min(prior, 15)
        for i in range(nb - 1, -1, -1):
            bit = (v >> i) & 1
            self.put_bit(("nnz", cat, i, prefix, pb), bit)
            prefix = (prefix << 1) | bit

    def get_nnz(self, cat, max_coeff, prior):
        nb = self._nnz_bits(max_coeff)
        v = 0
        prefix = 0
        pb = min(prior, 15)
        for i in range(nb - 1, -1, -1):
            bit = self.get_bit(("nnz", cat, i, prefix, pb))
            v = (v << 1) | bit
            prefix = (prefix << 1) | bit
        return v + 1

    # -- snapshot / rollback (compress-side literal fallback) -----------
    def snapshot(self):
        assert self.mode == "encode"
        rc = self.rc
        return (
            {k: list(v) for k, v in self.est.items()},
            (rc.low, rc.range, rc.cache, rc.cache_size, len(rc.out)),
            dict(self.bill),
            (rc, len(self.closed), self.cur_bins),
            {k: list(v) for k, v in self.wmix.items()},
            {k: list(v) for k, v in self.apm.items()},
        )

    def rollback(self, snap):
        (est, (low, rng, cache, csize, outlen), bill, (rc, ncl, cb), wmix,
         apm) = snap
        self.est = {k: list(v) for k, v in est.items()}
        self.wmix = {k: list(v) for k, v in wmix.items()}
        self.apm = {k: list(v) for k, v in apm.items()}
        # the active encoder at snapshot time may have been closed since;
        # restoring its registers + out length reopens it (finish() only
        # appends flush bytes past outlen and mutates registers)
        self.rc = rc
        del self.closed[ncl:]
        self.cur_bins = cb
        rc.low, rc.range, rc.cache, rc.cache_size = low, rng, cache, csize
        del rc.out[outlen:]
        self.bill = dict(bill)

    def finish(self):
        assert self.mode == "encode"
        if not self.B:
            return self.rc.finish()
        streams = [b for (_, b) in self.closed] + [self.rc.finish()]
        return _make_envelope(streams)


def _make_envelope(streams):
    """Multi-stream envelope: varint n, n varint lengths, concatenated
    bytes (the v2 'interleaved sub-streams' stream-blob payload)."""
    from ..utils.container import Writer

    w = Writer()
    w.varint(len(streams))
    for s in streams:
        w.varint(len(s))
    for s in streams:
        w.out += s
    return w.bytes()


def _parse_envelope(blob):
    from ..utils.container import Reader

    r = Reader(blob)
    lens = [r.varint() for _ in range(r.varint())]
    out = []
    for n in lens:
        out.append(bytes(blob[r.pos : r.pos + n]))
        r.pos += n
    return out
