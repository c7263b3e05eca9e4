// Adaptive recode model — C++ mirror of models/h264_model.py.
//
// The model-key tuple space is small and enumerable, so estimators live in
// DENSE per-class direct-indexed tables instead of a hash map (the probe +
// key-compare chain was the top profile cost).  A generation-stamped
// thread-local pool makes model construction O(1): cells whose generation
// predates the model are logically fresh (pos=neg=1) without any memset.
//
// Slot numbering/storage is internal — streams depend only on per-key
// estimator histories, so this layout change is byte-neutral (guarded by
// the Python differential suite).
#pragma once
#include <algorithm>
#include <cassert>
#include <cstdint>
#include <vector>
#if defined(__AVX2__) && !defined(AVT_NO_SIMD)
#include <immintrin.h>
#define AVT_AVX 1
#endif
#include "mix_tables.h"
#include "rangecoder.h"
#include "tables.h"

namespace avtpu {

constexpr int kHalveDefault = 0x60;
constexpr int kHalveSig = 0x50;
constexpr int kHalveFast = 0x18;  // model v4: fast mixer-input counter
constexpr int32_t kHistMag = 256;   // model v5: last-bit history input
constexpr int32_t kHist2Mag = 128;  // model v7: second-last-bit input
constexpr int kApmCells = 33;       // model v10: APM buckets per class
constexpr int kApmRate = 6;         // APM adaptation shift (lab rate sweep: 6 > 5 > 4)
constexpr int kApmHist = 5;         // stage-2 APM history contexts
                                    // (last,last2 in {00,01,10,11,none})

// model key classes (order is internal; independent per-key streams)
enum KeyCls : uint32_t {
  K_CTX, K_SKIP, K_IMBTYPE, K_I16CBF, K_I16CBC0, K_I16CBC1, K_I16PM1, K_I16PM0,
  K_PMBTYPE0, K_PMBTYPE_INTRA, K_PMBTYPE1, K_PMBTYPE2A, K_PMBTYPE2B,
  K_BMBTYPE0, K_BMBTYPE1, K_BMBTYPE2, K_BMBTYPE3, K_BMBTYPE4, K_BMBTYPE5,
  K_BMBTYPE6, K_BMBTYPE7, K_BMBTYPE_INTRA,
  K_PSUB0, K_PSUB1, K_PSUB2,
  K_BSUB0, K_BSUB1, K_BSUB2, K_BSUB3, K_BSUB4, K_BSUB5, K_BSUB6, K_BSUB7,
  K_T8X8, K_IPREDF, K_IPREDR, K_CPRED0, K_CPRED1, K_CPRED2,
  K_CBPL, K_CBPC0, K_CBPC1, K_QPD0, K_QPD1, K_QPD2,
  K_REF, K_MVD, K_MVDP, K_MVDE, K_MVDB, K_MVDS,
  K_CBF, K_SIG, K_LVL1, K_LVLG, K_LVLE, K_LVLB, K_SGN, K_NNZ,
  K_FIELDF,  // MBAFF mb_field_decoding_flag (appended: ids stay stable)
  K_PCMF, K_PCM,  // I_PCM escape bin + sample-byte bits
  K_SIMBTYPE,  // SI-slice mb_type prefix bin (appended: ids stay stable)
  // CAVLC bit-modeling classes (cavlc.h / h264/cavlc.py — appended):
  // exp-golomb classes key (a, phase prefix/suffix, bit idx); VLC-walk
  // classes key (table, bit idx); see cavlc.py for the key taxonomy
  K_VSKIP, K_VMBT, K_VSUB, K_VCPRED, K_VCBP, K_VDQP, K_VMVD, K_VREF,
  K_VTOK, K_VTZ, K_VRUN, K_VT1, K_VLP, K_VLS, K_VIPRED, K_VT8,
  K_NCLS,
};

// per-class field extents (a, b, c, d) — headroom over the parser's actual
// ranges; asserts catch drift in debug/fuzz builds.  constexpr so mkey()
// call sites fold base/stride lookups into immediates (the per-bin
// KeySpace::index unpack/re-multiply was a measurable hot-path cost).
struct KeySpace {
  uint32_t dims[K_NCLS][4];
  uint32_t base[K_NCLS];
  uint32_t stride[K_NCLS][4];
  uint32_t total;

  constexpr KeySpace() : dims{}, base{}, stride{}, total(0) {
    auto set = [&](uint32_t cls, uint32_t a, uint32_t b = 1, uint32_t c = 1,
                   uint32_t d = 1) {
      dims[cls][0] = a;
      dims[cls][1] = b;
      dims[cls][2] = c;
      dims[cls][3] = d;
    };
    for (uint32_t i = 0; i < K_NCLS; i++) set(i, 1);
    set(K_SKIP, 4, 4);
    set(K_IMBTYPE, 4);
    set(K_PMBTYPE0, 4);
    set(K_BMBTYPE0, 4);
    set(K_T8X8, 4);
    set(K_IPREDR, 4);
    set(K_CPRED0, 4);
    set(K_CBPL, 4, 4, 2);
    set(K_CBPC0, 4);
    set(K_CBPC1, 4);
    set(K_QPD0, 2);
    set(K_QPD1, 8);     // model v9: prev |qp_delta| magnitude context
    set(K_QPD2, 8, 8);  // (unary position, prev magnitude)
    set(K_I16CBC0, 4, 4);  // model v9: neighbor cbp_chroma (3 = unavail)
    set(K_I16CBC1, 2, 2);
    set(K_REF, 4, 4);
    set(K_MVD, 2, 4);
    set(K_MVDP, 2, 8);
    set(K_MVDE, 2, 8);
    set(K_MVDB, 2, 8);
    set(K_MVDS, 2);
    set(K_CBF, 32, 16, 8, 2);   // (cat + 16*field, inc + 4*quadrant, prior, intra)
    set(K_SIG, 64, 64, 8, 8);   // (cat + 16*intra + 32*field, pos, found, need)
    set(K_LVL1, 16, 128, 2, 8);
    set(K_LVLG, 32, 128, 8, 8);  // (cat + 16*intra, gt1 ctx + pos bucket, coeff, nzb)
    set(K_LVLE, 16, 8);
    set(K_LVLB, 16, 8);
    set(K_SGN, 16, 4, 4, 9);  // model v8: d = DC neighbor-sign context
    set(K_NNZ, 32, 8, 64, 16);  // (cat + 16*field, bit idx, prefix, prior)
    set(K_FIELDF, 4);
    set(K_PCM, 8);
    set(K_SIMBTYPE, 4);
    set(K_VSKIP, 1, 2, 16);
    set(K_VMBT, 9, 2, 16);  // (slice family + 3*neighbor-intra inc)
    set(K_VSUB, 2, 2, 16);
    set(K_VCPRED, 1, 2, 16);
    set(K_VCBP, 2, 2, 16);
    set(K_VDQP, 1, 2, 16);
    set(K_VMVD, 8, 2, 16);  // (comp + 2*prev-|mvd| bucket)
    set(K_VREF, 2, 2, 16);
    set(K_VTOK, 6, 16);
    set(K_VTZ, 28, 16);
    set(K_VRUN, 32, 16);  // (zerosLeft bucket + 8*coeff-index bucket)
    set(K_VT1, 4);
    set(K_VLP, 16, 8, 4);  // (prefix pos, suffixLength, block cat)
    set(K_VLS, 16, 8, 4);
    set(K_VIPRED, 4);
    set(K_VT8, 4);
    // Per-class axis order, slowest -> fastest.  The dense index is an
    // internal bijection (estimator identity is the (cls,a,b,c,d) tuple,
    // so axis order is byte-neutral); ordering the axes so the one that
    // varies per bin INSIDE a block is fastest turns a block's cell
    // accesses into adjacent-cache-line runs — the big classes
    // (SIG/LVLG/LVL1/NNZ, most of the pool and most of the bins) were
    // L2-miss-per-bin under the a-major layout.
    uint32_t perm[K_NCLS][4] = {};
    for (uint32_t i = 0; i < K_NCLS; i++) {
      perm[i][0] = 0; perm[i][1] = 1; perm[i][2] = 2; perm[i][3] = 3;
    }
    auto ord = [&](uint32_t cls, uint32_t p0, uint32_t p1, uint32_t p2,
                   uint32_t p3) {
      perm[cls][0] = p0; perm[cls][1] = p1; perm[cls][2] = p2;
      perm[cls][3] = p3;
    };
    ord(K_SIG, 0, 2, 3, 1);   // (a, found, need | pos): scan pos fastest
    ord(K_LVL1, 0, 2, 3, 1);  // (cat, intra, nzb | ctx+posbucket)
    ord(K_LVLG, 0, 3, 1, 2);  // (a, nzb | ctx+posbucket, coeff)
    ord(K_NNZ, 0, 3, 1, 2);   // (cat, prior | bit idx, prefix)
    uint32_t off = 0;
    for (uint32_t i = 0; i < K_NCLS; i++) {
      base[i] = off;
      uint32_t s = 1;
      for (int k = 3; k >= 0; k--) {
        stride[i][perm[i][k]] = s;
        s *= dims[i][perm[i][k]];
      }
      off += s;
    }
    total = off;
  }

  // keys carry the dense index in the low bits (see mkey); fits the trace
  // record's 24-bit slot field by construction
  static uint32_t index(uint64_t key) { return (uint32_t)key & 0xFFFFFF; }
};
inline constexpr KeySpace kKeys{};
static_assert(kKeys.total <= (1u << 24), "dense key index must fit 24 bits");

// key = cls<<40 | dense index.  The dense index is computed at the call
// site with compile-time-constant strides (kKeys is constexpr), so the
// model never re-derives it per bin.  Estimator identity per (cls,a,b,c,d)
// tuple is unchanged — streams are byte-identical to the packed-field
// encoding this replaces.
inline uint64_t mkey(uint32_t cls, uint32_t a = 0, uint32_t b = 0,
                     uint32_t c = 0, uint32_t dd = 0) {
  assert(cls < K_NCLS && a < kKeys.dims[cls][0] && b < kKeys.dims[cls][1] &&
         c < kKeys.dims[cls][2] && dd < kKeys.dims[cls][3]);
  return ((uint64_t)cls << 40) |
         (kKeys.base[cls] + a * kKeys.stride[cls][0] +
          b * kKeys.stride[cls][1] + c * kKeys.stride[cls][2] +
          dd * kKeys.stride[cls][3]);
}

// exact (pos << 16) / total for all reachable (pos, total) pairs
struct DivTab {
  uint16_t t[97 * 97] = {};  // zero-init: cells with pos > total are never
                             // consulted but DivStretchTab reads all of them
  DivTab() {
    for (int total = 1; total <= 96; total++)
      for (int pos = 0; pos <= total; pos++) {
        int32_t p = ((int32_t)pos << 16) / total;
        t[total * 97 + pos] = (uint16_t)(p > 0xFFFF ? 0xFFFF : p);
      }
  }
};
inline const DivTab kDiv{};

// Fused counter->stretch table: kDivStretch[(total)*97+pos] ==
// kStretch12[kDiv.t[...] >> 4] exactly (built integer-only from the two
// tables, so the device mirrors — which compute the two steps separately —
// stay bit-identical).  Replaces two dependent loads with one on the
// per-bin critical path.
struct DivStretchTab {
  int16_t t[97 * 97];
  DivStretchTab() {
    for (int i = 0; i < 97 * 97; i++) t[i] = kStretch12[kDiv.t[i] >> 4];
  }
};
inline const DivStretchTab kDivStretch{};

// Fused squash-grid requantization: kRequant12[p >> 4] ==
// kSquash[kStretch12[p >> 4] + 2048] exactly (one load instead of two on
// the per-bin critical path; the device mirrors compute the two lookups
// separately and stay bit-identical).
struct RequantTab {
  uint16_t t[4096];
  RequantTab() {
    for (int i = 0; i < 4096; i++) t[i] = kSquash[kStretch12[i] + 2048];
  }
};
inline const RequantTab kRequant12{};

// Lane code of a requantized p1: kLaneIdx.t[q] is the squash index of
// kRequant12.t[q], the LAST i with kSquash[i] == kRequant12.t[q] (the one
// the lane packer's reverse map, host/src/lanepack.cc, gives the same p1),
// so pass B of the lane form writes it with one load off the model's chain.
struct LaneIdxTab {
  uint16_t t[4096];
  LaneIdxTab() {
    std::vector<uint16_t> rev(1 << 16);
    for (int i = 0; i < 4096; i++) rev[kSquash[i]] = (uint16_t)i;
    for (int q = 0; q < 4096; q++) t[q] = rev[kRequant12.t[q]];
  }
};
inline const LaneIdxTab kLaneIdx{};

// Fused APM-bucket table: kSquashU[dot + 2048] ==
// kStretch12[kSquash[dot + 2048] >> 4] + 2048 exactly — the squash and
// its stretch re-bucketing both depend only on `dot`, so the fused load
// starts in PARALLEL with the kSquash load instead of chaining after it
// (one level off the per-bin serial chain; device mirrors compute the
// two lookups separately and stay bit-identical).
struct SquashUTab {
  int16_t t[4096];
  SquashUTab() {
    for (int i = 0; i < 4096; i++)
      t[i] = (int16_t)(kStretch12[kSquash[i] >> 4] + 2048);
  }
};
inline const SquashUTab kSquashU{};

// Thread-local estimator pool: generation stamps make per-model init O(1).
// One 8-byte cell per key — one cache line holds 8 cells, which is what
// makes the axis-ordered layouts above pay (the pool is ~6.5 MB, bigger
// than L2; per-bin cell loads are the dominant hot-path memory traffic).
// Counts fit u8 exactly: the halving limits bound pos/neg at
// kHalveDefault+1 = 97.  meta packs gen(28) | last(2)<<28 | last2(2)<<30;
// gen advances once per model/snapshot (one per slice), and ensure()
// resets the pool with a 64k-epoch safety margin below the 28-bit wrap.
struct EstPool {
  struct Cell {
    uint8_t pos, neg;
    uint8_t fpos, fneg;  // fast second counter (halve at kHalveFast <= 25)
    uint32_t meta;       // gen(28) | last<<28 | last2<<30 (2 = no history)
  };
  static constexpr uint32_t kGenMask = 0x0FFFFFFF;
  std::vector<Cell> cells;
  uint32_t gen_counter = 0;

  void ensure() {
    if (cells.empty() || gen_counter > 0x0FFF0000u) {
      cells.assign(kKeys.total, Cell{0, 0, 0, 0, 0});
      gen_counter = 0;
    }
  }
};
inline thread_local EstPool tls_pool;

class RecodeModel {
 public:
  // Packed trace: one u64 per bin, byte-aligned for cheap 2xu32 device
  // unpacking:  lo32 = slot(24) | bit<<24;  hi32 = pcab(16) | p1<<16.
  // p1 is the EXACT model probability for the bin (the recorder adapts its
  // estimators just like the encoder), so a pure vectorized range coder on
  // the device reproduces host streams without any estimator state —
  // the lane-parallel fast path.  slot/pcab remain for the est-on-device
  // kernels.  A single push_back per bin; a single buffer to ship.
  struct Trace {
    std::vector<uint64_t> recs;
    std::vector<uint8_t> limits;  // per slot (built by finalize_trace)
    std::vector<uint8_t> cls;     // per slot key class (mixer weight ctx)
    bool finalized = false;
  };

  // encode mode (recording=true: trace recorder, no entropy coding)
  explicit RecodeModel(bool recording = false) {
    if (recording)
      trace_ = new Trace();
    else
      enc_ = new RangeEncoder();
    init_pool();
  }
  // decode mode.  substream_bins (container v2): nonzero means `data` is a
  // multi-stream envelope (varint n, n varint lens, concatenated bytes) and
  // the range DECODER re-inits on the next sub-stream every B bins; the
  // estimator state runs across the whole scope (h264_model.py mirror).
  RecodeModel(const uint8_t* data, size_t size, uint32_t substream_bins = 0)
      : B_(substream_bins) {
    if (!B_) {
      dec_ = new RangeDecoder(data, size);
    } else {
      size_t pos = 0;
      auto varint = [&]() {
        uint64_t v = 0;
        int shift = 0;
        while (pos < size) {
          uint8_t b = data[pos++];
          v |= (uint64_t)(b & 0x7F) << shift;
          if (!(b & 0x80)) break;
          shift += 7;
        }
        return v;
      };
      uint64_t n = varint();
      // corrupted envelope defense: the stream count and every length are
      // attacker-controlled varints — clamp to what the blob can hold so
      // sub-stream spans never point past the buffer (fuzz finding)
      if (n > size) n = size;
      std::vector<uint64_t> lens(n);
      for (uint64_t i = 0; i < n; i++) lens[i] = varint();
      for (uint64_t i = 0; i < n; i++) {
        size_t len = (size_t)std::min<uint64_t>(lens[i], size - pos);
        subs_.emplace_back(data + pos, len);
        pos += len;
      }
      if (subs_.empty()) subs_.emplace_back(data, (size_t)0);
      dec_ = new RangeDecoder(subs_[0].first, subs_[0].second);
    }
    init_pool();
  }
  ~RecodeModel() {
    delete enc_;
    delete dec_;
    delete trace_;
  }
  RecodeModel(const RecodeModel&) = delete;

  // Split per-bin path: prepare() resolves the estimator cell and the mixed
  // probability; commit() runs the entropy coder + adaptation.  Callers that
  // know the key BEFORE the CABAC decode (Coder::bin) call prepare() first so
  // the model's load chain (cell -> divtab -> mix) overlaps the CABAC
  // decoder's serial range/offset chain instead of queuing behind it — the
  // single biggest host hot-path cost (sampled profile: put_bit ~48% self).
  struct Prep {
    EstPool::Cell* cell;  // resolved once; commit()/adapt() reuse it
    uint32_t idx;
    uint32_t p1;    // final coded probability (post-APM, squash-grid)
    uint32_t q;     // its requant row: p1 == kRequant12.t[q]
    uint32_t pmix;  // mixer output (pre-APM): the mixer learns on this
    int pcab;
    uint32_t cls;
    int32_t aj;     // APM cell index ((cls*kApmHist + h)*kApmCells + bucket)
    int32_t afrac;  // APM interpolation fraction (0..127)
    // mixer input vector (x[2] is the constant bias input 77; x[6], x[7]
    // are zero padding so the weight update can run as one 8-lane op)
    alignas(32) int32_t x[8];
  };
  Prep prepare(uint64_t key, int pcab = 0) {
    Prep pp;
    pp.cell = touch(key, &pp.idx);
    pp.pcab = pcab;
    pp.cls = (uint32_t)(key >> 40);
    pp.p1 = mix_prob(*pp.cell, pp.cls, pcab, &pp);
    return pp;
  }
  void commit(const Prep& pp, uint64_t key, int bit) {
    if (trace_) {
      // records carry the DENSE key index (fits 24 bits); finalize_trace()
      // remaps to first-appearance slot ids in one export-time pass
      trace_->recs.push_back(
          (uint64_t)(pp.idx | ((uint32_t)bit << 24)) |
          ((uint64_t)(uint32_t)pp.pcab << 32) | ((uint64_t)pp.p1 << 48));
      update_mix(pp, bit);
      adapt(*pp.cell, pp.cls, bit);
      return;
    }
    size_t n0 = bill ? enc_->out_size() : 0;
#ifndef AVT_AB_NOENC
    enc_->put(bit, pp.p1);
#endif
    if (bill) bill[key >> 40] += (enc_->out_size() - n0) * 8;
    update_mix(pp, bit);
    adapt(*pp.cell, pp.cls, bit);
  }
  void put_bit(uint64_t key, int bit, int pcab = 0) {
#ifdef AVT_AB_NOMODEL
    return;
#endif
    if (defer_) {
      defer_->push_back(pack_rec(key, bit, pcab));
      return;
    }
    commit(prepare(key, pcab), key, bit);
  }

  // --- two-pass (record/replay) split ------------------------------------
  // Pass A (parse): put_bit appends a packed record and touches NO model
  // state — the parser runs free of the model's tables and registers, and
  // a failed slice just truncates the buffer (no journal, no redo).
  // Pass B (replay_records): the model runs as a tight array loop over the
  // records; every future cell index is known, so the estimator pool
  // (~6.6 MB, the dominant per-bin memory traffic) is prefetched ahead of
  // use.  Record layout (superset of the trace record):
  //   bits 0..23  dense key index     bits 32..47  pcab
  //   bit  24     bin value           bits 48..63  p1 (filled by replay)
  //   bits 25..31 key class (cleared by trace replay)
  // State evolution in pass B is the exact put_bit sequence, so streams
  // are byte-identical to the single-pass interleaved path.
  static uint64_t pack_rec(uint64_t key, int bit, int pcab) {
    return (key & 0xFFFFFF) | ((uint64_t)(uint32_t)bit << 24) |
           ((key >> 40) << 25) | ((uint64_t)(uint32_t)pcab << 32);
  }
  void set_defer(std::vector<uint64_t>* buf) { defer_ = buf; }
  bool deferred() const { return defer_ != nullptr; }
  // records in the pass-A sink (0 outside pass A)
  size_t deferred_size() const { return defer_ ? defer_->size() : 0; }
  // trace-mode two-pass: pass A appends raw records straight into the
  // trace buffer (zero-copy — the pass-A buffer IS the trace), pass B
  // rewrites them in place with the exact p1 via replay_records
  size_t trace_mark() const { return trace_->recs.size(); }
  void set_defer_trace(bool on) { defer_ = on ? &trace_->recs : nullptr; }
  void truncate_trace(size_t mark) { trace_->recs.resize(mark); }
  void replay_trace_tail(size_t mark) {
    replay_records(trace_->recs.data() + mark, trace_->recs.size() - mark);
  }
  void replay_records(uint64_t* r, size_t n) {
    replay_each(r, n, [&](size_t i, uint32_t idx, int bit, int pcab,
                          uint32_t cls, const Prep& pp) {
      if (trace_) {
        // rewrite in place into the finalized trace record (the pass-A
        // buffer IS the trace buffer; finalize_trace slot-remaps later)
        r[i] = (uint64_t)(idx | ((uint32_t)bit << 24)) |
               ((uint64_t)(uint32_t)pcab << 32) | ((uint64_t)pp.p1 << 48);
      } else {
        size_t n0 = bill ? enc_->out_size() : 0;
#ifndef AVT_AB_NOENC
        enc_->put(bit, pp.p1);
#endif
        if (bill) bill[cls] += (enc_->out_size() - n0) * 8;
      }
    });
  }
  // Pass B of the lane form: the same model steps over pass A's records,
  // each bin written to out[i] as its lane code, the squash index of its
  // p1 (bits 0-11) and the bin (bit 12); the records are left as they are
  void replay_lane(const uint64_t* r, size_t n, uint16_t* out) {
    replay_each(r, n, [&](size_t i, uint32_t, int bit, int, uint32_t,
                          const Prep& pp) {
      out[i] = (uint16_t)(kLaneIdx.t[pp.q] | (uint32_t)bit << 12);
    });
  }

  // optional per-class recode-bit ledger (the "Avrecode Bill",
  // recode.cpp:642-668): caller-provided uint64[K_NCLS]
  uint64_t* bill = nullptr;

  // Optimistic mode (compress/extract entry points): skip the rollback journal
  // entirely — parse failures are rare (zero on the corpus), so they run
  // the scope optimistically and REDO the whole unit journaled if any slice
  // fails verify (process_gop / compress_inner).  snapshot()/rollback() must
  // not be called while set.  State evolution on the success path is
  // IDENTICAL to journaled mode, so streams are byte-identical.
  void set_optimistic(bool on) { optimistic_ = on; }
  int get_bit(uint64_t key, int pcab = 0) {
    if (B_) {
      if (cur_bins_ == B_) {
        si_++;
        // corrupted envelope: fewer sub-streams than the bin count needs —
        // zero-fill (the outer parse/verify rejects the garbage loudly)
        if (si_ < subs_.size())
          *dec_ = RangeDecoder(subs_[si_].first, subs_[si_].second);
        else
          *dec_ = RangeDecoder(nullptr, 0);
        cur_bins_ = 0;
      }
      cur_bins_++;
    }
    Prep pp = prepare(key, pcab);
    int bit = dec_->get(pp.p1);
    update_mix(pp, bit);
    adapt(*pp.cell, pp.cls, bit);
    return bit;
  }

  void put_nnz(int nnz, int cat, int max_coeff, int prior) {
    int v = nnz - 1, nb = bits_for(max_coeff - 1);
    uint32_t prefix = 0, pb = prior < 15 ? prior : 15;
    for (int i = nb - 1; i >= 0; i--) {
      int bit = (v >> i) & 1;
      put_bit(mkey(K_NNZ, cat, i, prefix, pb), bit);
      prefix = (prefix << 1) | bit;
    }
  }
  int get_nnz(int cat, int max_coeff, int prior) {
    int nb = bits_for(max_coeff - 1), v = 0;
    uint32_t prefix = 0, pb = prior < 15 ? prior : 15;
    for (int i = nb - 1; i >= 0; i--) {
      int bit = get_bit(mkey(K_NNZ, cat, i, prefix, pb));
      v = (v << 1) | bit;
      prefix = (prefix << 1) | bit;
    }
    return v + 1;
  }

  // --- single-pass compress / extract rollback -----------------------
  struct Snapshot {
    uint64_t epoch;
    size_t journal_len;
    uint64_t low;
    uint32_t range;
    uint8_t cache;
    uint64_t cache_size;
    size_t out_len;
    size_t rec_len, lim_len;  // trace mode
    int32_t wmix[K_NCLS * 8];  // mixer weights (small: full copy)
    uint16_t apm[K_NCLS * kApmHist * kApmCells];  // v10 APM (full copy)
  };

  Snapshot snapshot() {
    assert(!optimistic_ && "snapshot/rollback invalid in optimistic mode");
    // bump generation: future touches journal their prior state exactly once
    epoch_ = ++pool_->gen_counter;
    Snapshot s{};
    s.epoch = epoch_;
    s.journal_len = journal_.size();
    if (enc_) enc_->save(&s.low, &s.range, &s.cache, &s.cache_size, &s.out_len);
    if (trace_) {
      s.rec_len = trace_->recs.size();
      s.lim_len = trace_->limits.size();
    }
    std::copy(wmix_, wmix_ + K_NCLS * 8, s.wmix);
    std::copy(apm_, apm_ + K_NCLS * kApmHist * kApmCells, s.apm);
    return s;
  }
  void commit(const Snapshot& s) { journal_.resize(s.journal_len); }
  void rollback(const Snapshot& s) {
    for (size_t i = journal_.size(); i-- > s.journal_len;) {
      const Undo& u = journal_[i];
      EstPool::Cell& cc = pool_->cells[u.idx];
      cc.pos = u.pos;
      cc.neg = u.neg;
      cc.fpos = u.fpos;
      cc.fneg = u.fneg;
      cc.meta = u.meta;
    }
    journal_.resize(s.journal_len);
    if (enc_) enc_->restore(s.low, s.range, s.cache, s.cache_size, s.out_len);
    if (trace_) {
      trace_->recs.resize(s.rec_len);
      trace_->limits.resize(s.lim_len);
      trace_->cls.resize(s.lim_len);
    }
    std::copy(s.wmix, s.wmix + K_NCLS * 8, wmix_);
    std::copy(s.apm, s.apm + K_NCLS * kApmHist * kApmCells, apm_);
  }

  Bytes finish() { return enc_->finish(); }
  const Trace* trace() const { return trace_; }


  // Export-time trace finalization: remap dense key indices (written by
  // put_bit) to first-appearance slot ids and build the per-slot halving
  // limits.  One linear pass, run inside the (threaded) extraction worker —
  // this keeps the recorder slot id OUT of the per-bin hot path and the
  // estimator cell at 8 bytes.
  void finalize_trace() {
    if (!trace_ || trace_->finalized) return;
    trace_->finalized = true;
    static thread_local std::vector<uint32_t> remap, rstamp;
    static thread_local uint32_t rgen = 0;
    if (remap.size() != kKeys.total) {
      remap.assign(kKeys.total, 0);
      rstamp.assign(kKeys.total, 0);
      rgen = 0;
    }
    if (++rgen == 0) {
      std::fill(rstamp.begin(), rstamp.end(), 0u);
      rgen = 1;
    }
    for (auto& r : trace_->recs) {
      uint32_t i = (uint32_t)r & 0xFFFFFF;
      uint32_t slot;
      if (rstamp[i] == rgen) {
        slot = remap[i];
      } else {
        rstamp[i] = rgen;
        slot = (uint32_t)trace_->limits.size();
        remap[i] = slot;
        // class of index i = last cls with base[cls] <= i
        uint32_t lo = 0, hi = K_NCLS - 1;
        while (lo < hi) {
          uint32_t mid = (lo + hi + 1) >> 1;
          if (kKeys.base[mid] <= i) lo = mid;
          else hi = mid - 1;
        }
        trace_->limits.push_back(lo == K_SIG ? kHalveSig : kHalveDefault);
        trace_->cls.push_back((uint8_t)lo);
      }
      r = (r & ~(uint64_t)0xFFFFFF) | slot;
    }
  }
  // pre-size the record buffer (the caller estimates bins from payload size);
  // grows geometrically so repeated per-slice calls never trigger
  // linear-chain reallocations
  void reserve_trace(size_t extra_bins) {
    if (!trace_) return;
    size_t need = trace_->recs.size() + extra_bins;
    if (need > trace_->recs.capacity())
      trace_->recs.reserve(std::max(need, 2 * trace_->recs.capacity()));
  }

 private:
  // pass B's loop over pass A's records: emit(i, idx, bit, pcab, cls, pp)
  // sees each bin's prepared probability before the model adapts to it
  template <class Emit>
  void replay_each(const uint64_t* r, size_t n, Emit emit) {
    static_assert(K_NCLS <= 128, "cls must fit the 7-bit record field");
    constexpr size_t kPF = 24;  // cell prefetch distance (bins)
    for (size_t i = 0; i < n; i++) {
      if (i + kPF < n)
        __builtin_prefetch(&pool_->cells[(uint32_t)r[i + kPF] & 0xFFFFFF]);
      uint64_t v = r[i];
      uint32_t idx = (uint32_t)v & 0xFFFFFF;
      int bit = (int)(v >> 24) & 1;
      uint32_t cls = ((uint32_t)v >> 25) & 0x7F;
      int pcab = (int)((v >> 32) & 0xFFFF);
      uint64_t key = ((uint64_t)cls << 40) | idx;
      Prep pp = prepare(key, pcab);
      emit(i, idx, bit, pcab, cls, pp);
      update_mix(pp, bit);
      adapt(*pp.cell, cls, bit);
    }
  }

  static int bits_for(int v) {
    int n = 0;
    while (v >> n) n++;
    return n;
  }

  void init_pool() {
    pool_ = &tls_pool;
    pool_->ensure();
    start_gen_ = ++pool_->gen_counter;
    epoch_ = start_gen_;
    for (uint32_t c = 0; c < K_NCLS; c++) {
      wmix_[c * 8 + 0] = 24576;  // 0.375 in 16-frac
      wmix_[c * 8 + 1] = 24576;
      wmix_[c * 8 + 2] = 0;
      wmix_[c * 8 + 3] = 0;
      wmix_[c * 8 + 4] = 0;
      wmix_[c * 8 + 5] = 0;
      wmix_[c * 8 + 6] = 0;  // pad lanes (SIMD width); never move: x=0
      wmix_[c * 8 + 7] = 0;
    }
    // model v10: APM cells start at the identity map (squash of each
    // bucket's stretch-domain center), one 33-cell row per class
    uint16_t row[kApmCells];
    for (int k = 0; k < kApmCells; k++) {
      int32_t sc = k * 128 - 2048;
      sc = sc < -2047 ? -2047 : sc > 2047 ? 2047 : sc;
      row[k] = (uint16_t)kSquash[sc + 2048];
    }
    for (uint32_t c = 0; c < K_NCLS * kApmHist; c++)
      std::copy(row, row + kApmCells, &apm_[c * kApmCells]);
  }

  // Resolve key -> dense index, initializing / journaling as needed.
  // Both modes adapt counters now (the recorder needs live probabilities
  // for the p1 field), so both journal for rollback.
  EstPool::Cell* touch(uint64_t key, uint32_t* idx_out) {
    uint32_t i = kKeys.index(key);
    *idx_out = i;
    EstPool::Cell& c = pool_->cells[i];
    uint32_t m = c.meta;
    // One compare covers both modes: journaled mode stamps epoch_ on touch
    // (gen <= epoch_ always, so >= means == epoch_); optimistic mode never
    // bumps past start_gen_ == epoch_, so >= means "touched by this model".
    uint32_t g = m & EstPool::kGenMask;
    if (g >= epoch_) return &c;
    if (optimistic_) {  // miss == first touch for this model: init, stamp
      c.pos = c.neg = c.fpos = c.fneg = 1;
      c.meta = (2u << 28) | (2u << 30) | epoch_;
      return &c;
    }
    journal_.push_back({i, c.pos, c.neg, c.fpos, c.fneg, m});
    if (g < start_gen_) {  // fresh for this model
      c.pos = c.neg = c.fpos = c.fneg = 1;
      m = (2u << 28) | (2u << 30);
    }
    c.meta = (m & ~EstPool::kGenMask) | epoch_;
    return &c;
  }

  // Logistic mixing (round-2 model upgrade, lab-validated at +2.0% of
  // stream bytes over the round-1 linear mix — mixlab.h variant 6): mix
  // the counter estimator and the live CABAC prior in the stretch
  // (logit) domain with per-key-class learned weights.  All arithmetic is
  // int32-safe and floor-shift based, mirrored exactly by
  // models/h264_model.py and the device kernels; the shared stretch/
  // squash tables are generated once (tools/gen_mix_tables.py).
  // Hot-path layout note: all arithmetic below is exactly the scalar
  // formulation (int32 two's-complement adds are order-independent, mullo/
  // srai are exact), so the AVX2 path is byte-identical to the scalar one —
  // guarded by the Python differential suite and hash_corpus.py.
  uint32_t mix_prob(const EstPool::Cell& c, uint32_t cls, int pcab,
                    Prep* pp) {
#ifdef AVT_AB_NOMIX  // ablation build (timing experiments only)
    pp->x[0] = pp->x[1] = pp->x[3] = pp->x[4] = pp->x[5] = 0;
    pp->x[2] = 77; pp->x[6] = pp->x[7] = 0;
    pp->pmix = 0x8000; pp->aj = 0; pp->afrac = 0; pp->q = 0x800;
    return 0x8000;
#endif
    // the APM row base depends only on (cls, history) — both known here —
    // so it resolves off the post-squash critical chain (explicit
    // prefetching of the row measured neutral: it stays cache-resident)
    int32_t lh = (c.meta >> 28) & 3, lh2 = c.meta >> 30;
    int32_t h = (lh == 2 || lh2 == 2) ? 4 : lh * 2 + lh2;
    const uint16_t* arow =
        &apm_[((int32_t)cls * kApmHist + h) * kApmCells];
    int32_t x0 = kDivStretch.t[(c.pos + c.neg) * 97 + c.pos];
    int32_t x1 = pcab > 0 ? kStretch12[pcab >> 4] : 0;
    int32_t x3 = kDivStretch.t[(c.fpos + c.fneg) * 97 + c.fpos];
    // history inputs via direct index (last/last2 in {0,1,2}; 2 = none)
    static constexpr int32_t kHistLut[3] = {-kHistMag, kHistMag, 0};
    static constexpr int32_t kHist2Lut[3] = {-kHist2Mag, kHist2Mag, 0};
    int32_t x4 = kHistLut[(c.meta >> 28) & 3];
    int32_t x5 = kHist2Lut[c.meta >> 30];
    int32_t* x = pp->x;
    x[0] = x0; x[1] = x1; x[2] = 77; x[3] = x3; x[4] = x4; x[5] = x5;
    x[6] = 0; x[7] = 0;
    const int32_t* w = &wmix_[cls * 8];
    // scalar dot on purpose: the 6 imuls start in parallel and feed the
    // squash lookup on the serial chain — a SIMD dot (insert chain +
    // mullo + horizontal sum) measured slower, as did a register-cached
    // weight row (the vector dot it forces outweighs the saved loads)
    int32_t dot =
        ((w[0] >> 6) * x0 + (w[1] >> 6) * x1 + (w[2] >> 6) * 77 +
         (w[3] >> 6) * x3 + (w[4] >> 6) * x4 + (w[5] >> 6) * x5) >> 10;
    if (dot < -2048) dot = -2048;
    if (dot > 2047) dot = 2047;
    // model v10: APM/SSE stage — a secondary probability map keyed on
    // (class, 2-bit key history, stretch bucket of the mixer output)
    // refines the mixer probability (equal blend (p + apm) / 2 at
    // adaptation rate kApmRate=6 — mixlab variant 24, the blend/rate
    // sweep over the variant-20 base: equal blend +0.16% and rate 6
    // +0.04% over the shipped-first (3p+apm)/4 @ rate 5), and the blend
    // is requantized onto the squash grid so every emitted p1 stays in
    // the squash image (the device's 12-bit index transfer relies on it).
    // The two-stage chain (variants 18/19) bought more still but with
    // twice the loads/updates on the per-bin critical path.
    // kRequant12 fuses the stretch+squash requant into one load.
    int32_t p16 = kSquash[dot + 2048];
    pp->pmix = p16;
    int32_t u = kSquashU.t[dot + 2048];  // == stretch12[p16>>4]+2048
    int32_t j = u >> 7;                       // 0..31
    int32_t frac = u - (j << 7);
    pp->aj = ((int32_t)cls * kApmHist + h) * kApmCells + j;
    pp->afrac = frac;
    const uint16_t* a = arow + j;
    int32_t pa = (a[0] * (128 - frac) + a[1] * frac) >> 7;
    int32_t pb = (p16 + pa) >> 1;
    pb = pb < 1 ? 1 : pb > 65535 ? 65535 : pb;
    pp->q = (uint32_t)pb >> 4;
    return kRequant12.t[pp->q];
  }
  void update_mix(const Prep& pp, int bit) {
#ifdef AVT_AB_NOUPD
    return;
#endif
    // model v10: APM cells adapt toward the observed bit (rate kApmRate,
    // interpolation-weighted); the mixer learns on its own pre-APM output
    uint16_t* a = &apm_[pp.aj];
    int32_t tgt = bit << 16;
    a[0] = (uint16_t)(a[0] + (((tgt - a[0]) * (128 - pp.afrac)) >> (7 + kApmRate)));
    a[1] = (uint16_t)(a[1] + (((tgt - a[1]) * pp.afrac) >> (7 + kApmRate)));
    int32_t err = (bit << 16) - (int32_t)pp.pmix;
    int32_t* w = &wmix_[pp.cls * 8];
#ifdef AVT_AVX
    __m256i xv = _mm256_load_si256((const __m256i*)pp.x);
    __m256i wv = _mm256_loadu_si256((const __m256i*)w);
    __m256i dv = _mm256_srai_epi32(
        _mm256_mullo_epi32(_mm256_set1_epi32(err), xv), 14);
    __m256i nw = _mm256_add_epi32(wv, dv);
    nw = _mm256_min_epi32(
        _mm256_set1_epi32(1 << 24),
        _mm256_max_epi32(_mm256_set1_epi32(-(1 << 24)), nw));
    _mm256_storeu_si256((__m256i*)w, nw);  // pad lanes: x=0 -> unchanged
#else
    w[0] = wclamp(w[0] + ((err * pp.x[0]) >> 14));
    w[1] = wclamp(w[1] + ((err * pp.x[1]) >> 14));
    w[2] = wclamp(w[2] + ((err * 77) >> 14));
    w[3] = wclamp(w[3] + ((err * pp.x[3]) >> 14));
    w[4] = wclamp(w[4] + ((err * pp.x[4]) >> 14));
    w[5] = wclamp(w[5] + ((err * pp.x[5]) >> 14));
#endif
  }
  static int32_t wclamp(int32_t w) {
    return w < -(1 << 24) ? -(1 << 24) : w > (1 << 24) ? (1 << 24) : w;
  }
  static void adapt(EstPool::Cell& c, uint32_t cls, int bit) {
#ifdef AVT_AB_NOADAPT
    return;
#endif
    // model v7: shift the 2-bit history register (last -> last2, bit -> last)
    c.meta = (c.meta & EstPool::kGenMask) | ((c.meta << 2) & 0xC0000000u) |
             ((uint32_t)bit << 28);
    if (bit) {
      c.pos++;
      c.fpos++;
    } else {
      c.neg++;
      c.fneg++;
    }
    int limit = cls == K_SIG ? kHalveSig : kHalveDefault;
    if (c.pos + c.neg > limit) {
      c.pos = (c.pos + 1) >> 1;
      c.neg = (c.neg + 1) >> 1;
    }
    if (c.fpos + c.fneg > kHalveFast) {
      c.fpos = (c.fpos + 1) >> 1;
      c.fneg = (c.fneg + 1) >> 1;
    }
  }

  struct Undo {
    uint32_t idx;
    uint8_t pos, neg, fpos, fneg;
    uint32_t meta;
  };

  EstPool* pool_ = nullptr;
  int32_t wmix_[K_NCLS * 8];
  // model v10 secondary probability map, keyed (class, history, bucket)
  uint16_t apm_[K_NCLS * kApmHist * kApmCells];
  uint32_t start_gen_ = 0, epoch_ = 0;
  bool optimistic_ = false;
  std::vector<Undo> journal_;
  RangeEncoder* enc_ = nullptr;
  RangeDecoder* dec_ = nullptr;
  Trace* trace_ = nullptr;
  std::vector<uint64_t>* defer_ = nullptr;  // two-pass pass-A record sink
  // v2 sub-stream decode state
  uint32_t B_ = 0, cur_bins_ = 0;
  size_t si_ = 0;
  std::vector<std::pair<const uint8_t*, size_t>> subs_;
};

}  // namespace avtpu
