// Offline exact-cost replay of the REFERENCE model, for the ratio-parity
// table in BENCHMARKS.md (VERDICT round-1 item 6: "prove ratio >= the
// reference recoder").  The reference binary cannot be built here (its
// ffmpeg submodule is empty), so this replays its probability model over
// the bin stream our own parser produces and charges the idealized
// arithmetic-coding cost -log2(p) per bin.
//
// Faithful to the reference recoder's recode.cpp:
//   - estimator dynamics: pos/neg counters init 1/1, increment, halve
//     (x+1)/2 when total > 0x60 (0x50 inside the significance map)
//     [recode.cpp:1037-1054,1064]
//   - regular CABAC bins keyed by their ffmpeg context pointer == the
//     CABAC context index [recode.cpp:683-690 default model_key(context,0,0)]
//   - ALL bypass bins share ONE estimator (&bypass_context), all
//     terminate bins share one [recode.cpp:1188-1198,1056]
//   - significance maps: the block's nonzero count is serialized first,
//     out of band, bit by bit with neighbor/prev-frame keys
//     [recode.cpp:855-936]; the sig flags are then coded with
//     nnz-informed keys [recode.cpp:805-808]; last_significant flags
//     (PIP_SIGNIFICANCE_EOB) are never coded at all [recode.cpp:1080,1445]
//   - the estimator map persists across slices and pictures for the whole
//     file [recode.cpp:669-672 "reset should do nothing"]
//   - neighbor availability checks PICTURE bounds only (not slice
//     membership, not coded-ness) [recode.cpp:426-478]; an uncoded
//     neighbor reads nnz 0 from the zero-filled frame meta; the above-
//     neighbor bit replicates the reference's `if (above_nonzero)`
//     (value, not availability) quirk [recode.cpp:878-880]
//
// Deliberately favors the reference where its real costs are ignored:
// no probability-quantization loss ((range/total)*pos), no carry/stuffing
// bytes, protobuf framing + surrogate markers uncounted, flush charged at
// 1 byte/slice (its terminator can emit more).  A "reference >= this
// replay" bound makes our ">= reference" comparison conservative.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace avtpu {

class RefScorer {
 public:
  // per-class bit accumulators (whole file)
  enum { RB_CTX, RB_BYPASS, RB_TERM, RB_NNZ, RB_SIG, RB_NCLS };
  double bits[RB_NCLS] = {};
  double stream_bytes = 0;   // sum over slices of ceil(bits/8) + 1 flush
  uint64_t n_bins = 0;

  struct Neighbor {
    bool has = false;
    int mbx = 0, mby = 0, slot = 0;
  };

  void frame_start(int W, int H) {
    if (W != W_ || H != H_) {
      W_ = W;
      H_ = H;
      plane_[0].assign((size_t)W * H, Meta());
      plane_[1].assign((size_t)W * H, Meta());
      cur_ = 0;
    } else {
      cur_ ^= 1;  // recode.cpp:836 cur_frame flip on new frame_num
      std::fill(plane_[cur_].begin(), plane_[cur_].end(), Meta());
    }
  }

  void begin_slice() { slice_bits_ = 0; }
  void commit_slice() {
    stream_bytes += std::ceil(slice_bits_ / 8.0) + 1.0;  // +1: finish()
  }

  void ctx_bin(int ctx, int bit) { score(key(K_CTX, ctx, 0), bit, false); }
  void bypass_bin(int bit) { score(key(K_BYPASS, 0, 0), bit, false); }
  void terminate_bin(int bit) { score(key(K_TERM, 0, 0), bit, false); }

  // one residual block that went through the significance map.
  // ffcat: ffmpeg residual category (0 luma DC, 1 luma AC, 2 luma 4x4,
  // 3 chroma DC, 4 chroma AC, 5 luma 8x8); slot: scan8-equivalent
  // sub-block slot (see parser.h ref_slot); sig[0..max_coeff): the
  // significance map (1 at each nonzero), nnz its population count
  void sig_block(int mbx, int mby, int slot, Neighbor left, Neighbor above,
                 int ffcat, int max_coeff, int is_dc, int chroma422,
                 const int* sig, int nnz) {
    Meta& meta = at(cur_, mbx, mby);
    // recode.cpp:938-955 end_coding_type runs BEFORE finished_queueing:
    // own meta (is_8x8, nnz) is final when the nnz bits are keyed
    meta.is8x8 = meta.is8x8 || max_coeff > 32;
    meta.coded = true;
    meta.nnz[slot] = (uint8_t)nnz;

    // --- out-of-band nonzero-count bits (recode.cpp:855-917) ---
    int serialized_bits = max_coeff > 16 ? 6 : max_coeff > 4 ? 4 : 2;
    uint32_t left_nnz = left.has ? at(cur_, left.mbx, left.mby).nnz[left.slot] : 0;
    uint32_t above_nnz =
        above.has ? at(cur_, above.mbx, above.mby).nnz[above.slot] : 0;
    uint32_t prev_nnz = at(cur_ ^ 1, mbx, mby).nnz[slot];
    int subkey2 = (meta.is8x8 ? 1 : 0) + is_dc * 2 + chroma422 + ffcat * 4;
    uint32_t serialized_so_far = 0;
    for (int i = 0; i < serialized_bits; i++) {
      uint32_t cur_bit = 1u << i;
      int left_bit = left.has ? (left_nnz >= cur_bit) : 2;
      // reference quirk: tests the VALUE, not availability
      int above_bit = above_nnz ? (above_nnz >= cur_bit) : 2;
      int prev_bit = prev_nnz >= cur_bit;
      uint32_t sk1 =
          serialized_so_far + 64 * prev_bit + 128 * left_bit + 384 * above_bit;
      int bit = (nnz >> i) & 1;
      score(key(K_NNZ0 + i, sk1, (uint32_t)subkey2), bit, false,
            RB_NNZ);
      if (bit) serialized_so_far |= cur_bit;
    }

    // --- significance flags with nnz-informed keys (recode.cpp:805-808,
    // FSM at 986-1028); EOB/last flags cost nothing (recode.cpp:1080) ---
    int observed = 0;
    for (int i = 0; i < max_coeff - 1; i++) {
      int zz;
      if (is_dc && chroma422)
        zz = i < 2 ? 0 : i < 4 ? 1 : 2;  // sig_coeff_offset_dc
      else if (max_coeff > 32)
        zz = kRefSig8x8 ? kRefSig8x8[i] : 0;
      else
        zz = i;
      uint32_t sk1 = (uint32_t)(64 * nnz + observed);
      uint32_t sk2 = (uint32_t)(is_dc + zz * 2 + 16 * 2 * kCatLookup[ffcat]);
      score(key(K_SIG, sk1, sk2), sig[i], /*sig_map=*/true, RB_SIG);
      if (sig[i]) {
        observed++;
        if (observed == nnz) break;  // EOB bin: free
      }
    }
  }

  // spec 8x8 sig ctx table (frame row) — wired by parser.h to its kSig8x8
  const uint8_t* kRefSig8x8 = nullptr;

 private:
  // recode.cpp:703 cat_lookup
  static constexpr int kCatLookup[14] = {105 + 0,  105 + 15, 105 + 29,
                                         105 + 44, 105 + 47, 402,
                                         484 + 0,  484 + 15, 484 + 29,
                                         660,      528 + 0,  528 + 15,
                                         528 + 29, 718};
  enum {
    K_CTX = 0,
    K_BYPASS,
    K_TERM,
    K_SIG,
    K_NNZ0,  // + bit index (STATE_FOR_NUM_NONZERO_BIT[i] anchors), 6 kinds
  };
  struct Est {
    uint32_t pos = 1, neg = 1;
  };
  struct Meta {
    uint8_t nnz[51] = {};  // scan8-equivalent slots, 48..50 = DC planes
    bool is8x8 = false;
    bool coded = false;
  };

  static uint64_t key(uint32_t kind, uint32_t a, uint32_t b) {
    return (uint64_t)kind | ((uint64_t)a << 8) | ((uint64_t)b << 40);
  }

  void score(uint64_t k, int bit, bool sig_map, int cls = -1) {
    Est& e = est_[k];
    uint32_t total = e.pos + e.neg;
    double cost = std::log2((double)total / (bit ? e.pos : e.neg));
    if (cls < 0)
      cls = (k & 0xFF) == K_CTX      ? RB_CTX
            : (k & 0xFF) == K_BYPASS ? RB_BYPASS
                                     : RB_TERM;
    bits[cls] += cost;
    slice_bits_ += cost;
    n_bins++;
    if (bit)
      e.pos++;
    else
      e.neg++;
    // recode.cpp:1046-1051
    if (e.pos + e.neg > (uint32_t)(sig_map ? 0x50 : 0x60)) {
      e.pos = (e.pos + 1) / 2;
      e.neg = (e.neg + 1) / 2;
    }
  }

  Meta& at(int p, int mbx, int mby) { return plane_[p][(size_t)mby * W_ + mbx]; }

  std::unordered_map<uint64_t, Est> est_;
  std::vector<Meta> plane_[2];
  int W_ = -1, H_ = -1, cur_ = 0;
  double slice_bits_ = 0;
};

}  // namespace avtpu
