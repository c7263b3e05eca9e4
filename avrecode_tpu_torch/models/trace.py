"""Trace-recording model: captures the per-slice recode bin stream as dense
arrays for the device (JAX/Pallas) compress path.

In compress direction the model never influences parsing (bins come from the
real CABAC payload), so a recorder is a drop-in replacement for RecodeModel:
the parser runs once on the host producing, per slice,

    slots : int32[T]   dense estimator slot per bin (first-appearance order)
    bits  : int32[T]   the bin values
    pcabs : int32[T]   CABAC-state mixing prior (0 = no mixing)
    p1s   : int32[T]   EXACT model probability per bin (recorder adapts its
                       estimators like the encoder), so a bare range coder
                       on the device reproduces host streams with no
                       estimator state — the lane-parallel fast path
    limits: int32[S]   per-slot halving limit (0x50 sig / 0x60 default)

which the device consumes to reproduce the exact host model arithmetic
(ops/estimator_jax.py, ops/lane_coder.py) — the dense-array replacement for
the per-bin std::map path called out as the reference's hotspot
(SURVEY.md §3 hot loop #3).
"""

from ..ops._mix_tables import SQUASH, STRETCH12
from .h264_model import (APM_RATE, HALVE_DEFAULT, HALVE_FAST, HALVE_SIG,
                         HIST2_MAG, HIST_MAG, _apm_row)

# key class name -> numeric id for the device mixer weight table; MUST
# follow host/src/model.h::KeyCls order (the native extractor exports the
# same ids via avtpu_xtrace)
CLS_IDS = {
    n: i for i, n in enumerate([
        "ctx", "skip", "imbtype", "i16cbf", "i16cbc0", "i16cbc1", "i16pm1",
        "i16pm0", "pmbtype0", "pmbtype_intra", "pmbtype1", "pmbtype2a",
        "pmbtype2b", "bmbtype0", "bmbtype1", "bmbtype2", "bmbtype3",
        "bmbtype4", "bmbtype5", "bmbtype6", "bmbtype7", "bmbtype_intra",
        "psub0", "psub1", "psub2", "bsub0", "bsub1", "bsub2", "bsub3",
        "bsub4", "bsub5", "bsub6", "bsub7", "t8x8", "ipredf", "ipredr",
        "cpred0", "cpred1", "cpred2", "cbpl", "cbpc0", "cbpc1", "qpd0",
        "qpd1", "qpd2", "ref", "mvd", "mvdp", "mvde", "mvdb", "mvds",
        "cbf", "sig", "lvl1", "lvlg", "lvle", "lvlb", "sgn", "nnz",
        "fieldf",  # MBAFF mb_field_decoding_flag (appended: ids are stable)
        "pcmf", "pcm",  # I_PCM escape bin + sample-byte bits
        "simbtype",  # SI-slice mb_type prefix bin (appended)
        # CAVLC bit-modeling classes (h264/cavlc.py — appended, same order
        # as host/src/model.h::KeyCls)
        "vskip", "vmbt", "vsub", "vcpred", "vcbp", "vdqp", "vmvd", "vref",
        "vtok", "vtz", "vrun", "vt1", "vlp", "vls", "vipred", "vt8",
    ])
}
N_CLS = len(CLS_IDS)


class TraceModel:
    def __init__(self):
        self.slot_of = {}
        self.limits = []
        self.cls = []  # per-slot key-class id (device mixer weight context)
        self.slots = []
        self.bits = []
        self.pcabs = []
        self.p1s = []
        self.est = {}  # slot -> [pos, neg]; adapted exactly like RecodeModel
        self.wmix = {}  # class id -> [w_est, w_cab, w_bias]
        self.apm = {}  # (class id, history ctx) -> 33-cell APM row (v10)

    def _slot(self, key):
        s = self.slot_of.get(key)
        if s is None:
            s = len(self.limits)
            self.slot_of[key] = s
            self.limits.append(HALVE_SIG if key[0] == "sig" else HALVE_DEFAULT)
            self.cls.append(CLS_IDS[key[0]])
        return s

    def put_bit(self, key, bit, pcab=None):
        s = self._slot(key)
        e = self.est.get(s)
        if e is None:
            e = self.est[s] = [1, 1, 1, 1, 2, 2]
        # identical integer arithmetic to RecodeModel._prob_update/
        # _update_mix/_adapt (logistic mixing + dual-rate counter, model v4)
        pe = (e[0] << 16) // (e[0] + e[1])
        pe = 1 if pe < 1 else (0xFFFF if pe > 0xFFFF else pe)
        pf = (e[2] << 16) // (e[2] + e[3])
        pf = 1 if pf < 1 else (0xFFFF if pf > 0xFFFF else pf)
        x0 = STRETCH12[pe >> 4]
        x1 = STRETCH12[pcab >> 4] if pcab else 0
        x3 = STRETCH12[pf >> 4]
        x4 = 0 if e[4] == 2 else (HIST_MAG if e[4] else -HIST_MAG)
        x5 = 0 if e[5] == 2 else (HIST2_MAG if e[5] else -HIST2_MAG)
        c = self.cls[s]
        w = self.wmix.get(c)
        if w is None:
            w = self.wmix[c] = [24576, 24576, 0, 0, 0, 0]
        dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77
               + (w[3] >> 6) * x3 + (w[4] >> 6) * x4
               + (w[5] >> 6) * x5) >> 10
        dot = -2048 if dot < -2048 else (2047 if dot > 2047 else dot)
        # model v10 APM stage (RecodeModel._prob_update mirror): secondary
        # map keyed on (class, 2-bit key history, stretch bucket)
        pmix = SQUASH[dot + 2048]
        u = STRETCH12[pmix >> 4] + 2048
        j = u >> 7
        frac = u - (j << 7)
        h = 4 if (e[4] == 2 or e[5] == 2) else e[4] * 2 + e[5]
        a = self.apm.get((c, h))
        if a is None:
            a = self.apm[(c, h)] = _apm_row()
        pa = (a[j] * (128 - frac) + a[j + 1] * frac) >> 7
        pb = (pmix + pa) >> 1
        pb = 1 if pb < 1 else (65535 if pb > 65535 else pb)
        p1 = SQUASH[STRETCH12[pb >> 4] + 2048]
        bit = int(bit)
        tgt = bit << 16
        a[j] += ((tgt - a[j]) * (128 - frac)) >> (7 + APM_RATE)
        a[j + 1] += ((tgt - a[j + 1]) * frac) >> (7 + APM_RATE)
        err = tgt - pmix  # the mixer learns on its pre-APM output
        for k, x in ((0, x0), (1, x1), (2, 77), (3, x3), (4, x4), (5, x5)):
            wn = w[k] + ((err * x) >> 14)
            w[k] = -(1 << 24) if wn < -(1 << 24) else (
                (1 << 24) if wn > (1 << 24) else wn)
        e[5] = e[4]
        e[4] = bit
        e[bit ^ 1] += 1
        e[2 + (bit ^ 1)] += 1
        if e[0] + e[1] > self.limits[s]:
            e[0] = (e[0] + 1) >> 1
            e[1] = (e[1] + 1) >> 1
        if e[2] + e[3] > HALVE_FAST:
            e[2] = (e[2] + 1) >> 1
            e[3] = (e[3] + 1) >> 1
        self.slots.append(s)
        self.bits.append(bit)
        self.pcabs.append(0 if pcab is None else int(pcab))
        self.p1s.append(p1)

    def snapshot(self):
        """GOP-scope slice rollback support (codec._scan_blocks snapshots the
        model before each slice attempt; a failed slice must restore the
        recorder exactly — trace arrays truncated, estimator/mixer state and
        the slot table restored)."""
        return (
            len(self.bits),
            len(self.limits),
            {s: e[:] for s, e in self.est.items()},
            {c: w[:] for c, w in self.wmix.items()},
            {c: a[:] for c, a in self.apm.items()},
        )

    def rollback(self, snap):
        nbits, nslots, est, wmix, apm = snap
        self.apm = apm
        del self.slots[nbits:], self.bits[nbits:]
        del self.pcabs[nbits:], self.p1s[nbits:]
        if len(self.limits) > nslots:
            del self.limits[nslots:], self.cls[nslots:]
            self.slot_of = {k: s for k, s in self.slot_of.items() if s < nslots}
        self.est = est
        self.wmix = wmix

    def put_nnz(self, nnz, cat, max_coeff, prior):
        v = nnz - 1
        nb = (max_coeff - 1).bit_length()
        prefix = 0
        pb = min(prior, 15)
        for i in range(nb - 1, -1, -1):
            bit = (v >> i) & 1
            self.put_bit(("nnz", cat, i, prefix, pb), bit)
            prefix = (prefix << 1) | bit

    def __len__(self):
        return len(self.bits)
