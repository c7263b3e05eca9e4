// Offline mixing laboratory — measures candidate probability-model
// upgrades (logistic mixing, SSE/APM) against the production model on the
// REAL bin/key/pcab stream, before committing to the byte-identical
// Python/C++ mirror discipline.  Hooked into Coder like RefScorer; float
// math is fine here (the lab picks the design, production re-measures its
// integerization).  Costs are idealized -log2(p) bits.
//
// Baseline V0 replicates the PRODUCTION model exactly (model v5: logistic
// mixing + dual-rate counter + last-bit history) so new variants measure
// against what ships; variant 9 replays the round-1 linear mix.
#pragma once

#include <cmath>
#include <cstdint>
#include <vector>

#include "model.h"

namespace avtpu {

class MixLab {
 public:
  // variant: 0 baseline only; 1 logistic mix (per-class weights);
  // 2 logistic mix (class x confidence-bucket weights); 3 baseline + SSE;
  // 4 variant-2 + SSE
  int variant = 1;
  int slice_qp = 26;  // variants 12/14: per-slice conditioning input
  double lr = 0.02;        // mixer learning rate
  double w_est = 3.0;      // initial weight: counter-estimator input
  double w_cab = 3.0;      // initial weight: CABAC-prior input
  double sse_rate = 5;     // APM adaptation shift
  double bits_base = 0, bits_mix = 0;
  uint64_t n_bins = 0;

  MixLab() {
    pos_.assign(kKeys.total, 1);
    neg_.assign(kKeys.total, 1);
    size_t nw = (size_t)K_NCLS * NBUCK * 3;
    w_.assign(nw, 0.0);
    winit_.assign((size_t)K_NCLS * NBUCK, 0);
    // APM: class x 33 stretch buckets, cell = probability in [0,1]
    apm_.assign((size_t)K_NCLS * 33, -1.0);
  }

  void gop_start() {  // production model scope: per-GOP reset
    std::fill(pos_.begin(), pos_.end(), 1);
    std::fill(neg_.begin(), neg_.end(), 1);
    std::fill(w_.begin(), w_.end(), 0.0);
    std::fill(apm_.begin(), apm_.end(), -1.0);
    winit_.assign((size_t)K_NCLS * NBUCK, 0);
    wi_.assign((size_t)K_NCLS * 3, 0);
    fpos_.clear();
    fneg_.clear();
    std::fill(w4init_, w4init_ + K_NCLS, 0);
    std::fill(wbinit_, wbinit_ + K_NCLS, 0);
    lastb_.clear();
    lastb2_.clear();
    std::fill(w5init_, w5init_ + K_NCLS, 0);
    std::fill(w6init_, w6init_ + K_NCLS, 0);
    std::fill(w2init_, w2init_ + K_NCLS, 0);
    wqp_.clear();
    wqpinit_.clear();
    apmi_.clear();
    std::fill(apmi_init_, apmi_init_ + K_NCLS, 0);
    apmi2_.clear();
    std::fill(apmi2_init_, apmi2_init_ + K_NCLS * 5, 0);
    for (uint32_t c = 0; c < K_NCLS; c++) {
      wi_[(size_t)c * 3 + 0] = 24576;  // 0.375
      wi_[(size_t)c * 3 + 1] = 24576;
      wi_[(size_t)c * 3 + 2] = 0;
    }
  }

  void on_bin(uint64_t key, int pcab, int bit) {
    uint32_t i = kKeys.index(key);
    uint32_t cls = (uint32_t)(key >> 40);
    int pos = pos_[i], neg = neg_[i], total = pos + neg;

    // --- V0 baseline: exact PRODUCTION probability (model v5) ---
    {
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      if (lastb_.empty()) lastb_.assign(kKeys.total, 2);
      int32_t* w = &wb_[(size_t)cls * 5];
      if (!wbinit_[cls]) {
        wbinit_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0; w[4] = 0;
      }
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int lb = lastb_[i];
      int32_t x4 = lb == 2 ? 0 : lb ? 256 : -256;
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3 + (w[4] >> 6) * x4) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      double pb0 = p16 / 65536.0;
      bits_base += -std::log2(bit ? pb0 : 1.0 - pb0);
      int32_t err = (bit << 16) - p16;
      int32_t xs[5] = {x0, x1, 77, x3, x4};
      for (int k = 0; k < 5; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
    }

    // --- round-1 linear mix (historical; variant 9 reports it as mix) ---
    int32_t p = (int32_t)(((int64_t)pos << 16) / total);
    if (p > 0xFFFF) p = 0xFFFF;
    if (pcab > 0) {
      int32_t w = 4 * total < 78 ? 4 * total : 78;
      p = (p * w + pcab * (80 - w)) / 80;
      if (p < 1) p = 1;
      if (p > 0xFFFF) p = 0xFFFF;
    }
    double pb = p / 65536.0;
    if (variant == 9) {
      bits_mix += -std::log2(bit ? pb : 1.0 - pb);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }

    // --- candidate ---
    double pm = pb;
    if (variant == 12 || variant == 13) {
      // v5 + a SIXTH input: 12 = slice qp (centered, scaled); 13 = slot
      // confidence (stretch-scaled log of the slow counter total) — lets
      // the mixer discount cold estimators without bucketed cold-start
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      if (lastb_.empty()) lastb_.assign(kKeys.total, 2);
      int32_t* w = &wi6_[(size_t)cls * 6];
      if (!w6init_[cls]) {
        w6init_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0; w[4] = 0; w[5] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int lb = lastb_[i];
      int32_t x4 = lb == 2 ? 0 : lb ? 256 : -256;
      int32_t x5;
      if (variant == 12) {
        x5 = (slice_qp - 26) * 16;
      } else {
        int conf = 0, t = total;
        while (t > 1) { t >>= 1; conf++; }  // log2(total) in [1, 6]
        x5 = (conf - 3) * 128;
      }
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3 + (w[4] >> 6) * x4 +
                     (w[5] >> 6) * x5) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      int32_t err = (bit << 16) - p16;
      int32_t xs[6] = {x0, x1, 77, x3, x4, x5};
      for (int k = 0; k < 6; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 14) {
      // v5 with qp-BUCKETED weights (cls x qp/8 bucket): measures whether
      // per-qp specialization beats the shared-weight cold start
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      if (lastb_.empty()) lastb_.assign(kKeys.total, 2);
      if (wqp_.empty()) wqp_.assign((size_t)K_NCLS * 7 * 5, 0);
      if (wqpinit_.empty()) wqpinit_.assign((size_t)K_NCLS * 7, 0);
      int qb = slice_qp < 0 ? 0 : slice_qp > 51 ? 6 : slice_qp / 8;
      size_t wi = ((size_t)cls * 7 + qb) * 5;
      int32_t* w = &wqp_[wi];
      if (!wqpinit_[(size_t)cls * 7 + qb]) {
        wqpinit_[(size_t)cls * 7 + qb] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0; w[4] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int lb = lastb_[i];
      int32_t x4 = lb == 2 ? 0 : lb ? 256 : -256;
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3 + (w[4] >> 6) * x4) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      int32_t err = (bit << 16) - p16;
      int32_t xs[5] = {x0, x1, 77, x3, x4};
      for (int k = 0; k < 5; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant >= 17 && variant <= 25) {
      // Round-4 candidate, SHIP-EXACT integerization of variant 15: the
      // production v7 6-input mixer -> integer APM (33 cells per class
      // over the 12-bit stretch domain, interpolated rate-5 update) ->
      // blend (3*p + apm) >> 2 -> requantize onto the squash grid
      // (kSquash[kStretch12[p >> 4] + 2048]) so every emitted p1 stays in
      // the squash image and the device's 12-bit index transfer holds.
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      if (lastb_.empty()) lastb_.assign(kKeys.total, 2);
      if (lastb2_.empty()) lastb2_.assign(kKeys.total, 2);
      int32_t* w = &wi6_[(size_t)cls * 6];
      if (!w6init_[cls]) {
        w6init_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0; w[4] = 0; w[5] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int lb = lastb_[i], lb2 = lastb2_[i];
      int32_t x4 = lb == 2 ? 0 : lb ? 256 : -256;
      int32_t x5 = lb2 == 2 ? 0 : lb2 ? 128 : -128;
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3 + (w[4] >> 6) * x4 +
                     (w[5] >> 6) * x5) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      // integer APM keyed on (class, stretch bucket of the mixer output)
      if (apmi_.empty()) apmi_.assign((size_t)K_NCLS * 33, 0);
      int32_t* a = &apmi_[(size_t)cls * 33];
      if (!apmi_init_[cls]) {
        apmi_init_[cls] = 1;
        for (int k = 0; k < 33; k++) {
          int32_t sc = k * 128 - 2048;
          sc = sc < -2047 ? -2047 : sc > 2047 ? 2047 : sc;
          a[k] = kSquash[sc + 2048];
        }
      }
      int32_t u = kStretch[p16 >> 4] + 2048;  // [1, 4095]
      int j = u >> 7;
      if (j > 31) j = 31;
      int32_t frac = u - (j << 7);
      if (variant >= 20 && variant <= 25) {
        // single APM keyed on (cls, history, bucket): half the loads of
        // the two-stage chain — how much of the gain survives?
        // 21/22: blend-weight sweep ((p+apm)/2, (p+3apm)/4 vs 20's
        // (3p+apm)/4)
        int h = (lb == 2 || lb2 == 2) ? 4 : (lb * 2 + lb2);
        if (apmi2_.empty()) apmi2_.assign((size_t)K_NCLS * 5 * 33, 0);
        int32_t* ah = &apmi2_[((size_t)cls * 5 + h) * 33];
        if (!apmi2_init_[(size_t)cls * 5 + h]) {
          apmi2_init_[(size_t)cls * 5 + h] = 1;
          for (int k = 0; k < 33; k++) {
            int32_t sc = k * 128 - 2048;
            sc = sc < -2047 ? -2047 : sc > 2047 ? 2047 : sc;
            ah[k] = kSquash[sc + 2048];
          }
        }
        int32_t pah = (ah[j] * (128 - frac) + ah[j + 1] * frac) >> 7;
        int32_t pbh = variant == 20 ? (3 * p16 + pah) >> 2
                      : variant == 22 ? (p16 + 3 * pah) >> 2
                                      : (p16 + pah) >> 1;  // 21/23/24
        pbh = pbh < 1 ? 1 : pbh > 65535 ? 65535 : pbh;
        pm = kSquash[kStretch[pbh >> 4] + 2048] / 65536.0;
        int32_t tgth = bit << 16;
        int rsh = variant == 23 ? 11 : variant == 24 ? 13 : variant == 25 ? 14 : 12;
        ah[j] += ((tgth - ah[j]) * (128 - frac)) >> rsh;
        ah[j + 1] += ((tgth - ah[j + 1]) * frac) >> rsh;
        int32_t errh = (bit << 16) - p16;
        int32_t xsh[6] = {x0, x1, 77, x3, x4, x5};
        for (int k = 0; k < 6; k++) {
          int32_t wn = w[k] + ((errh * xsh[k]) >> 14);
          w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24)
                                                              : wn;
        }
        lastb2_[i] = lastb_[i];
        bits_mix += -std::log2(bit ? pm : 1.0 - pm);
        n_bins++;
        adapt_only(i, cls, bit);
        return;
      }
      int32_t pa = (a[j] * (128 - frac) + a[j + 1] * frac) >> 7;
      int32_t pb = (3 * p16 + pa) >> 2;
      pb = pb < 1 ? 1 : pb > 65535 ? 65535 : pb;
      int32_t tgt = bit << 16;
      // variant 18: second APM in the chain, keyed on (cls, 2-bit key
      // history); its vote averages in before requantization
      int j2 = 0, frac2 = 0;
      int32_t* a2 = nullptr;
      if (variant == 19) {
        // latency-optimized chain: stage 2 keyed on the SAME stage-1
        // bucket (from p16, not pb) so both APM loads start in parallel
        int h = (lb == 2 || lb2 == 2) ? 4 : (lb * 2 + lb2);
        if (apmi2_.empty()) apmi2_.assign((size_t)K_NCLS * 5 * 33, 0);
        a2 = &apmi2_[((size_t)cls * 5 + h) * 33];
        if (!apmi2_init_[(size_t)cls * 5 + h]) {
          apmi2_init_[(size_t)cls * 5 + h] = 1;
          for (int k = 0; k < 33; k++) {
            int32_t sc = k * 128 - 2048;
            sc = sc < -2047 ? -2047 : sc > 2047 ? 2047 : sc;
            a2[k] = kSquash[sc + 2048];
          }
        }
        j2 = j;
        frac2 = frac;
        int32_t pa2 = (a2[j2] * (128 - frac2) + a2[j2 + 1] * frac2) >> 7;
        pb = (3 * pb + pa2) >> 2;
        pb = pb < 1 ? 1 : pb > 65535 ? 65535 : pb;
      }
      if (variant == 18) {
        int h = (lb == 2 || lb2 == 2) ? 4 : (lb * 2 + lb2);  // 0..4
        if (apmi2_.empty()) apmi2_.assign((size_t)K_NCLS * 5 * 33, 0);
        a2 = &apmi2_[((size_t)cls * 5 + h) * 33];
        if (!apmi2_init_[(size_t)cls * 5 + h]) {
          apmi2_init_[(size_t)cls * 5 + h] = 1;
          for (int k = 0; k < 33; k++) {
            int32_t sc = k * 128 - 2048;
            sc = sc < -2047 ? -2047 : sc > 2047 ? 2047 : sc;
            a2[k] = kSquash[sc + 2048];
          }
        }
        int32_t u2 = kStretch[pb >> 4] + 2048;
        j2 = u2 >> 7;
        if (j2 > 31) j2 = 31;
        frac2 = u2 - (j2 << 7);
        int32_t pa2 = (a2[j2] * (128 - frac2) + a2[j2 + 1] * frac2) >> 7;
        pb = (3 * pb + pa2) >> 2;
        pb = pb < 1 ? 1 : pb > 65535 ? 65535 : pb;
      }
      int32_t pq = kSquash[kStretch[pb >> 4] + 2048];  // squash-grid requant
      pm = pq / 65536.0;
      a[j] += ((tgt - a[j]) * (128 - frac)) >> 12;  // >> (7 + sse_rate 5)
      a[j + 1] += ((tgt - a[j + 1]) * frac) >> 12;
      if (a2) {
        a2[j2] += ((tgt - a2[j2]) * (128 - frac2)) >> 12;
        a2[j2 + 1] += ((tgt - a2[j2 + 1]) * frac2) >> 12;
      }
      int32_t err = (bit << 16) - p16;  // mixer learns on its own output
      int32_t xs[6] = {x0, x1, 77, x3, x4, x5};
      for (int k = 0; k < 6; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      lastb2_[i] = lastb_[i];
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 15 || variant == 16) {
      // round-4 candidates on the PRODUCTION (v7) 6-input mixer base:
      //   15: + APM/SSE on the mixer output, blended (p + 3*apm)/4
      //   16: + a second mixing layer (stage-2 logistic mixer over
      //       [stretch(p1), counter stretch, bias], identity-initialized)
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      if (lastb_.empty()) lastb_.assign(kKeys.total, 2);
      if (lastb2_.empty()) lastb2_.assign(kKeys.total, 2);
      int32_t* w = &wi6_[(size_t)cls * 6];
      if (!w6init_[cls]) {
        w6init_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0; w[4] = 0; w[5] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int lb = lastb_[i], lb2 = lastb2_[i];
      int32_t x4 = lb == 2 ? 0 : lb ? 256 : -256;
      int32_t x5 = lb2 == 2 ? 0 : lb2 ? 128 : -128;
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3 + (w[4] >> 6) * x4 +
                     (w[5] >> 6) * x5) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      if (variant == 15) {
        double pa = apm(cls, pm, bit);
        pm = std::min(65535.5 / 65536.0,
                      std::max(0.5 / 65536.0, (3.0 * pm + pa) / 4.0));
      } else {
        // stage 2: y = [stretch12(p16), x0, bias]; w20 starts at identity
        int32_t* w2 = &wi2b_[(size_t)cls * 3];
        if (!w2init_[cls]) {
          w2init_[cls] = 1;
          w2[0] = 65536; w2[1] = 0; w2[2] = 0;
        }
        int32_t y0 = kStretch[p16 >> 4];
        int32_t dot2 = ((w2[0] >> 6) * y0 + (w2[1] >> 6) * x0 +
                        (w2[2] >> 6) * 77) >> 10;
        dot2 = dot2 < -2048 ? -2048 : dot2 > 2047 ? 2047 : dot2;
        int32_t q16 = kSquash[dot2 + 2048];
        pm = q16 / 65536.0;
        int32_t err2 = (bit << 16) - q16;
        int32_t ys[3] = {y0, x0, 77};
        for (int k = 0; k < 3; k++) {
          int32_t wn = w2[k] + ((err2 * ys[k]) >> 14);
          w2[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24)
                                                                : wn;
        }
      }
      int32_t err = (bit << 16) - p16;
      int32_t xs[6] = {x0, x1, 77, x3, x4, x5};
      for (int k = 0; k < 6; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      lastb2_[i] = lastb_[i];
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 11) {
      // v5 + SECOND-last bit as a 6th input (2-bit history)
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      if (lastb_.empty()) lastb_.assign(kKeys.total, 2);
      if (lastb2_.empty()) lastb2_.assign(kKeys.total, 2);
      int32_t* w = &wi6_[(size_t)cls * 6];
      if (!w6init_[cls]) {
        w6init_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0; w[4] = 0; w[5] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int lb = lastb_[i], lb2 = lastb2_[i];
      int32_t x4 = lb == 2 ? 0 : lb ? 256 : -256;
      int32_t x5 = lb2 == 2 ? 0 : lb2 ? 128 : -128;
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3 + (w[4] >> 6) * x4 +
                     (w[5] >> 6) * x5) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      int32_t err = (bit << 16) - p16;
      int32_t xs[6] = {x0, x1, 77, x3, x4, x5};
      for (int k = 0; k < 6; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      lastb2_[i] = lastb_[i];
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 10) {
      // v4 + per-slot last-bit history as a 5th input (PAQ-style run bit)
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      if (lastb_.empty()) lastb_.assign(kKeys.total, 2);  // 2 = no history
      int32_t* w = &wi5_[(size_t)cls * 5];
      if (!w5init_[cls]) {
        w5init_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0; w[4] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int lb = lastb_[i];
      int32_t x4 = lb == 2 ? 0 : lb ? 256 : -256;
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3 + (w[4] >> 6) * x4) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      int32_t err = (bit << 16) - p16;
      int32_t xs[5] = {x0, x1, 77, x3, x4};
      for (int k = 0; k < 5; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      lastb_[i] = bit;
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 8) {
      // v4 production + APM/SSE on top (the baseline block above already
      // computed the production probability and updated wb_; recompute it
      // here cheaply via the same state is avoided by passing through the
      // double: re-derive from bits_base delta is messy — instead rerun
      // the same arithmetic on the CURRENT (pre-adapt) state)
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      int32_t* w = &wi4_[(size_t)cls * 4];
      if (!w4init_[cls]) {
        w4init_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      double pmix = p16 / 65536.0;
      double pout = apm(cls, pmix, bit);
      pout = std::min(65535.5 / 65536.0, std::max(0.5 / 65536.0, pout));
      bits_mix += -std::log2(bit ? pout : 1.0 - pout);
      n_bins++;
      int32_t err = (bit << 16) - p16;
      int32_t xs[4] = {x0, x1, 77, x3};
      for (int k = 0; k < 4; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 7) {
      // variant 6 + a FAST second counter (halve at 0x18) as a 4th input:
      // does a dual-rate estimator add anything beyond the mixer?
      init_int_tables();
      if (fpos_.empty()) {
        fpos_.assign(kKeys.total, 1);
        fneg_.assign(kKeys.total, 1);
      }
      int32_t* w = &wi4_[(size_t)cls * 4];
      if (!w4init_[cls]) {
        w4init_[cls] = 1;
        w[0] = 24576; w[1] = 24576; w[2] = 0; w[3] = 0;
      }
      int fp = fpos_[i], fn = fneg_[i];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      pe = pe > 0xFFFF ? 0xFFFF : pe < 1 ? 1 : pe;
      int32_t pf = (int32_t)(((int64_t)fp << 16) / (fp + fn));
      pf = pf > 0xFFFF ? 0xFFFF : pf < 1 ? 1 : pf;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x3 = kStretch[pf >> 4];
      int32_t dot = ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
                     (w[3] >> 6) * x3) >> 10;
      dot = dot < -2048 ? -2048 : dot > 2047 ? 2047 : dot;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      int32_t err = (bit << 16) - p16;
      int32_t xs[4] = {x0, x1, 77, x3};
      for (int k = 0; k < 4; k++) {
        int32_t wn = w[k] + ((err * xs[k]) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 6) {
      // int32-safe production formulation: weights 16-frac clamped to
      // +-2^24, dot via (w>>6)*x >> 10 (the update keeps full weight
      // precision; only the dot truncates to 10-frac)
      init_int_tables();
      int32_t* w = &wi_[(size_t)cls * 3];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      if (pe > 0xFFFF) pe = 0xFFFF;
      if (pe < 1) pe = 1;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x2 = 77;
      int32_t dot =
          ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * x2) >> 10;
      if (dot < -2048) dot = -2048;
      if (dot > 2047) dot = 2047;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      int32_t err = (bit << 16) - p16;
      for (int k = 0; k < 3; k++) {
        int32_t x = k == 0 ? x0 : k == 1 ? x1 : x2;
        int32_t wn = w[k] + ((err * x) >> 14);
        w[k] = wn < -(1 << 24) ? -(1 << 24) : wn > (1 << 24) ? (1 << 24) : wn;
      }
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 5) {
      // exact-integer formulation (the production design): 12-bit stretch/
      // squash tables, per-class {w_est, w_cab, w_bias} int32 1/65536,
      // update dw = (err * x) >> 14  (lr ~= 0.0156)
      init_int_tables();
      int32_t* w = &wi_[(size_t)cls * 3];
      int32_t pe = (int32_t)(((int64_t)pos << 16) / total);
      if (pe > 0xFFFF) pe = 0xFFFF;
      if (pe < 1) pe = 1;
      int32_t x0 = kStretch[pe >> 4];
      int32_t x1 = pcab > 0 ? kStretch[pcab >> 4] : 0;
      int32_t x2 = 77;
      int64_t dot64 = (int64_t)w[0] * x0 + (int64_t)w[1] * x1 +
                      (int64_t)w[2] * x2;
      int32_t dot = (int32_t)(dot64 >> 16);
      if (dot < -2048) dot = -2048;
      if (dot > 2047) dot = 2047;
      int32_t p16 = kSquash[dot + 2048];
      pm = p16 / 65536.0;
      int32_t err = (bit << 16) - p16;
      w[0] += (err * x0) >> 14;
      w[1] += (err * x1) >> 14;
      w[2] += (err * x2) >> 14;
      bits_mix += -std::log2(bit ? pm : 1.0 - pm);
      n_bins++;
      adapt_only(i, cls, bit);
      return;
    }
    if (variant == 1 || variant == 2 || variant == 4) {
      int buck = variant == 1 ? 0 : conf_bucket(total);
      double* w = &w_[((size_t)cls * NBUCK + buck) * 3];
      if (!winit_[(size_t)cls * NBUCK + buck]) {
        winit_[(size_t)cls * NBUCK + buck] = 1;
        w[0] = w_est / 8.0;
        w[1] = w_cab / 8.0;
        w[2] = 0.0;
      }
      double pe = std::min(65535, std::max(1, (int)(((int64_t)pos << 16) /
                                                    total))) / 65536.0;
      double x0 = st(pe);
      double x1 = pcab > 0 ? st(pcab / 65536.0) : 0.0;
      double x2 = 0.3;  // bias input
      double dot = w[0] * x0 + w[1] * x1 + w[2] * x2;
      pm = sq(dot);
      double err = lr * (bit - pm);
      w[0] += err * x0;
      w[1] += err * x1;
      w[2] += err * x2;
    }
    if (variant == 3 || variant == 4) pm = apm(cls, pm, bit);
    pm = std::min(65535.5 / 65536.0, std::max(0.5 / 65536.0, pm));
    bits_mix += -std::log2(bit ? pm : 1.0 - pm);
    n_bins++;

    // --- production adaptation (shared by V0 and candidates) ---
    adapt_only(i, cls, bit);
  }

  // mirror of RecodeModel::put_nnz key generation (pcab = 0)
  void on_nnz(int nnz, int cat, int max_coeff, int prior) {
    int v = nnz - 1, nb = 0;
    while ((max_coeff - 1) >> nb) nb++;
    uint32_t prefix = 0, pb = prior < 15 ? prior : 15;
    for (int i = nb - 1; i >= 0; i--) {
      int bit = (v >> i) & 1;
      on_bin(mkey(K_NNZ, cat, i, prefix, pb), 0, bit);
      prefix = (prefix << 1) | bit;
    }
  }

 private:
  // production adaptation: slow + fast counters + history (model v5)
  void adapt_only(uint32_t i, uint32_t cls, int bit) {
    if (!lastb_.empty()) lastb_[i] = (uint8_t)bit;
    if (bit) {
      pos_[i]++;
      fpos_[i]++;
    } else {
      neg_[i]++;
      fneg_[i]++;
    }
    int limit = cls == K_SIG ? kHalveSig : kHalveDefault;
    if (pos_[i] + neg_[i] > limit) {
      pos_[i] = (pos_[i] + 1) >> 1;
      neg_[i] = (neg_[i] + 1) >> 1;
    }
    if (fpos_[i] + fneg_[i] > 0x18) {
      fpos_[i] = (fpos_[i] + 1) >> 1;
      fneg_[i] = (fneg_[i] + 1) >> 1;
    }
  }

  void init_int_tables() {
    if (!kSquash.empty()) return;
    kStretch.resize(4096);
    kSquash.resize(4096);
    for (int q = 0; q < 4096; q++) {
      double p = (q * 16 + 8) / 65536.0;
      int s = (int)std::lround(256.0 * std::log(p / (1.0 - p)));
      kStretch[q] = std::max(-2047, std::min(2047, s));
    }
    for (int s = 0; s < 4096; s++) {
      double p = 65536.0 / (1.0 + std::exp(-(s - 2048) / 256.0));
      int v = (int)std::lround(p);
      kSquash[s] = std::max(1, std::min(65535, v));
    }
  }

  static constexpr int NBUCK = 8;
  static int conf_bucket(int total) {  // total in [2, 96]
    int b = 0;
    int t = total >> 1;
    while (t > 1 && b < NBUCK - 1) {
      t >>= 1;
      b++;
    }
    return b;
  }
  static double st(double p) { return std::log(p / (1.0 - p)); }
  static double sq(double x) { return 1.0 / (1.0 + std::exp(-x)); }

  // PAQ-style APM: per (cls, stretch bucket) probability cell, linear
  // interpolation between the two neighboring buckets; cells init lazily
  // to the identity (the incoming probability itself)
  double apm(uint32_t cls, double pin, int bit) {
    double s = std::max(-16.0, std::min(16.0, st(pin)));
    double f = (s + 16.0) / 32.0 * 32.0;  // 0..32
    int b0 = (int)f;
    if (b0 > 31) b0 = 31;
    double frac = f - b0;
    double* c0 = &apm_[(size_t)cls * 33 + b0];
    double* c1 = c0 + 1;
    if (*c0 < 0) *c0 = sq(b0 / 32.0 * 32.0 - 16.0);
    if (*c1 < 0) *c1 = sq((b0 + 1) / 32.0 * 32.0 - 16.0);
    double pout = *c0 * (1.0 - frac) + *c1 * frac;
    double rate = 1.0 / (1 << (int)sse_rate);
    *c0 += (bit - *c0) * rate * (1.0 - frac);
    *c1 += (bit - *c1) * rate * frac;
    return pout;
  }

  std::vector<int> pos_, neg_;
  std::vector<double> w_;
  std::vector<uint8_t> winit_;
  std::vector<double> apm_;
  std::vector<int32_t> wi_, kStretch, kSquash;
  std::vector<int> fpos_, fneg_;
  int32_t wi4_[K_NCLS * 4] = {};
  uint8_t w4init_[K_NCLS] = {};
  int32_t wb_[K_NCLS * 5] = {};
  uint8_t wbinit_[K_NCLS] = {};
  std::vector<uint8_t> lastb_, lastb2_;
  int32_t wi5_[K_NCLS * 5] = {};
  uint8_t w5init_[K_NCLS] = {};
  int32_t wi6_[K_NCLS * 6] = {};
  int32_t wi2b_[K_NCLS * 3] = {};  // variant 16 stage-2 weights
  std::vector<int32_t> apmi_;      // variant 17 integer APM cells
  uint8_t apmi_init_[K_NCLS] = {};
  std::vector<int32_t> apmi2_;     // variant 18 second-stage APM cells
  uint8_t apmi2_init_[K_NCLS * 5] = {};
  uint8_t w2init_[K_NCLS] = {};
  uint8_t w6init_[K_NCLS] = {};
  std::vector<int32_t> wqp_;   // variant 14: (cls x qp bucket) weights
  std::vector<uint8_t> wqpinit_;
};

}  // namespace avtpu
