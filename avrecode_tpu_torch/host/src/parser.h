// H.264 CABAC slice-data parser — C++ mirror of h264/mbparse.py +
// h264/coders.py (same walk, both directions, deterministic-bin elision).
#pragma once
#include <cstdint>
#include <cstring>
#include <vector>
#include "cabac.h"
#include "h264.h"
#include "mixlab.h"
#include "model.h"
#include "refscore.h"

namespace avtpu {

// MB classes (mbparse.py)
enum MbClass : uint8_t {
  MB_UNSEEN = 0, MB_P_SKIP, MB_B_SKIP, MB_B_DIRECT, MB_INTER,
  MB_I_NXN, MB_I16, MB_I_PCM,
  MB_SI,  // SI macroblock (Intra_4x4 content, qs-domain reconstruction)
};
enum Pred : uint8_t { PRED_NONE = 0, PRED_L0 = 1, PRED_L1 = 2, PRED_BI = 3, PRED_DIRECT = 4 };

// residual categories
enum Cat { CAT_LUMA_DC = 0, CAT_LUMA_AC, CAT_LUMA_4x4, CAT_CHROMA_DC, CAT_CHROMA_AC, CAT_LUMA_8x8 };
static const int kMaxCoeff[14] = {16, 15, 16, 4, 15, 64,
                                  16, 15, 16, 64, 16, 15, 16, 64};
// coded_block_flag ctx base per ctxBlockCat (9.3.3.1.1.9): 4:4:4 Cb/Cr
// extensions at 460-483 (non-8x8) and 1012-1023 (8x8 luma/Cb/Cr)
static const int kCbfCtxBase[14] = {85,  89,  93,  97,  101, 1012, 460,
                                    464, 468, 1016, 472, 476, 480, 1020};
// cat -> colour plane for the 4:4:4 luma-style residual rows
static const int kCatPlane[14] = {0, 0, 0, -1, -1, 0, 1, 1, 1, 1, 2, 2, 2, 2};
static const int kCatDC[3] = {0, 6, 10};
static const int kCatAC[3] = {1, 7, 11};
static const int kCat44[3] = {2, 8, 12};
static const int kCat88[3] = {5, 9, 13};
static inline bool cat_is_88(int cat) { return cat == 5 || cat == 9 || cat == 13; }
static inline bool cat_is_dc3(int cat) { return cat == 0 || cat == 6 || cat == 10; }

// geometry (geometry.py): Z-order blk idx <-> 4x4 grid coords
struct Geom {
  int blk4_x[16], blk4_y[16], raster_to_blk4[16];
  constexpr Geom() : blk4_x(), blk4_y(), raster_to_blk4() {
    for (int i = 0; i < 16; i++) {
      blk4_x[i] = 2 * ((i >> 2) & 1) + (i & 1);
      blk4_y[i] = 2 * (i >> 3) + ((i >> 1) & 1);
    }
    for (int i = 0; i < 16; i++) raster_to_blk4[blk4_y[i] * 4 + blk4_x[i]] = i;
  }
};
static constexpr Geom G{};

// B mb_type table: (npart, shape 0=16x16,1=16x8,2=8x16,3=8x8sub, modes)
struct BType { int npart, shape; Pred m0, m1; };
static const BType kBType[23] = {
    {1, 0, PRED_DIRECT, PRED_NONE}, {1, 0, PRED_L0, PRED_NONE},
    {1, 0, PRED_L1, PRED_NONE},     {1, 0, PRED_BI, PRED_NONE},
    {2, 1, PRED_L0, PRED_L0},       {2, 2, PRED_L0, PRED_L0},
    {2, 1, PRED_L1, PRED_L1},       {2, 2, PRED_L1, PRED_L1},
    {2, 1, PRED_L0, PRED_L1},       {2, 2, PRED_L0, PRED_L1},
    {2, 1, PRED_L1, PRED_L0},       {2, 2, PRED_L1, PRED_L0},
    {2, 1, PRED_L0, PRED_BI},       {2, 2, PRED_L0, PRED_BI},
    {2, 1, PRED_L1, PRED_BI},       {2, 2, PRED_L1, PRED_BI},
    {2, 1, PRED_BI, PRED_L0},       {2, 2, PRED_BI, PRED_L0},
    {2, 1, PRED_BI, PRED_L1},       {2, 2, PRED_BI, PRED_L1},
    {2, 1, PRED_BI, PRED_BI},       {2, 2, PRED_BI, PRED_BI},
    {4, 3, PRED_NONE, PRED_NONE},
};
// B sub types: (nsub, shape 0=8x8,1=8x4,2=4x8,3=4x4, mode)
struct BSub { int nsp, shape; Pred mode; };
static const BSub kBSub[13] = {
    {1, 0, PRED_DIRECT}, {1, 0, PRED_L0}, {1, 0, PRED_L1}, {1, 0, PRED_BI},
    {2, 1, PRED_L0},     {2, 2, PRED_L0}, {2, 1, PRED_L1}, {2, 2, PRED_L1},
    {2, 1, PRED_BI},     {2, 2, PRED_BI}, {4, 3, PRED_L0}, {4, 3, PRED_L1},
    {4, 3, PRED_BI},
};

// Per-picture MB state (mbparse.py PicState / reference FrameBuffer analog).
struct PicState {
  int w = 0, h = 0;
  std::vector<int32_t> slice_id;
  std::vector<uint8_t> mbclass, skip, cbp_luma, cbp_chroma, t8x8, chroma_mode;
  std::vector<uint8_t> cbf_luma_dc;            // [h*w]
  std::vector<uint8_t> cbf_luma;               // [h*w*16]
  std::vector<uint8_t> cbf_chroma_dc;          // [h*w*2]
  std::vector<uint8_t> cbf_chroma_ac;          // [h*w*16] comp*8+sub
  std::vector<uint8_t> nnz_luma;               // [h*w*16]
  std::vector<uint8_t> nnz_luma_dc;            // [h*w]
  std::vector<uint8_t> nnz_chroma_dc;          // [h*w*2]
  std::vector<uint8_t> nnz_chroma_ac;          // [h*w*16] comp*8+sub
  // abs mvd clamped to 33: the only reader (parse_mvd's 2-neighbor sum)
  // classifies s into {<3, <=32, >32}, and min(v,33) preserves that
  // classification exactly while keeping the array (the biggest per-picture
  // zero/copy cost) at 1 byte per entry
  std::vector<uint8_t> mvd;                    // [2*h*w*16*2]
  std::vector<int8_t> refidx;                  // [2*h*w*4]
  // MBAFF: per-MB field flag (pairs share a value; rows interleave pairs)
  std::vector<uint8_t> field;
  // 4:4:4: Cb/Cr planes carry luma-style per-4x4 cbf/nnz maps ([2][n*16];
  // cbf_chroma_dc / nnz_chroma_dc double as the per-plane DC maps)
  std::vector<uint8_t> cbf_c44, nnz_c44;
  // model v8: sign of each block's first (DC) coefficient, +1/-1 (0 =
  // absent) — neighbor context for DC sign coding (mbparse.py mirror)
  std::vector<int8_t> sgn_luma;       // [h*w*16]
  std::vector<int8_t> sgn_luma_dc;    // [h*w]
  std::vector<int8_t> sgn_chroma_dc;  // [h*w*2]
  std::vector<int8_t> sgn_c44;        // [2*h*w*16]

  void init(int W, int H) {
    w = W;
    h = H;
    size_t n = (size_t)W * H;
    slice_id.assign(n, -1);
    mbclass.assign(n, 0);
    skip.assign(n, 0);
    cbp_luma.assign(n, 0);
    cbp_chroma.assign(n, 0);
    t8x8.assign(n, 0);
    chroma_mode.assign(n, 0);
    cbf_luma_dc.assign(n, 0);
    cbf_luma.assign(n * 16, 0);
    cbf_chroma_dc.assign(n * 2, 0);
    cbf_chroma_ac.assign(n * 16, 0);
    nnz_luma.assign(n * 16, 0);
    nnz_luma_dc.assign(n, 0);
    nnz_chroma_dc.assign(n * 2, 0);
    nnz_chroma_ac.assign(n * 16, 0);
    mvd.assign(n * 2 * 16 * 2, 0);
    refidx.assign(n * 2 * 4, -1);
    field.assign(n, 0);
    cbf_c44.assign(2 * n * 16, 0);
    nnz_c44.assign(2 * n * 16, 0);
    sgn_luma.assign(n * 16, 0);
    sgn_luma_dc.assign(n, 0);
    sgn_chroma_dc.assign(n * 2, 0);
    sgn_c44.assign(2 * n * 16, 0);
  }
};

// Direction-aware coder (coders.py CompressCoder/DecompressCoder merged).
struct Coder {
  bool is_compress;
  CtxStates states;
  CabacXcoder* xc = nullptr;     // compress: fused decode + verify re-encode
  CabacEncoder enc;              // decompress: output
  RecodeModel* model = nullptr;  // may be null (validation pass)
  RefScorer* ref = nullptr;      // optional reference-model replay (refscore.h)
  MixLab* mix = nullptr;         // optional model-upgrade lab (mixlab.h)
  const uint8_t* payload = nullptr;
  size_t payload_size = 0;
  uint64_t n_bins = 0;

  ~Coder() { delete xc; }

  void init_compress(const uint8_t* p, size_t n, int qp, int idc) {
    is_compress = true;
    payload = p;
    payload_size = n;
    xc = new CabacXcoder(p, n);
    states.init(qp, idc);
  }
  void init_decompress(int qp, int idc, RecodeModel* m) {
    is_compress = false;
    states.init(qp, idc);
    model = m;
  }

  int cabac_p1(int ctx) const { return kCabacP1[states.s[ctx]]; }
  // bins recorded so far in pass A (0 outside it)
  size_t recorded() const { return model ? model->deferred_size() : 0; }

  // I_PCM: escape bin (modeled so decompress knows) + raw samples at the
  // byte boundary after the flushed terminate; engines restart (9.3.1.2)
  int pcm_flag() {
    if (is_compress) {
      int b = raw_terminate();
      if (model) model->put_bit(mkey(K_PCMF), b, 0);
      return b;
    }
    int b = model->get_bit(mkey(K_PCMF), 0);
    enc.terminate(b);
    return b;
  }
  void pcm_samples(int n) {
    if (is_compress) {
      size_t start = xc->bytes().size();
      if (start + (size_t)n > payload_size)
        throw Desync("pcm samples beyond payload");
      if (model) {
        for (int k = 0; k < n; k++) {
          uint8_t byte = payload[start + k];
          for (int i = 0; i < 8; i++)
            model->put_bit(mkey(K_PCM, i), (byte >> (7 - i)) & 1, 0);
        }
      }
      xc->pcm_resume((size_t)n);
      bill_anchor = xc->bitpos();
      return;
    }
    Bytes buf((size_t)n);
    for (int k = 0; k < n; k++) {
      int v = 0;
      for (int i = 0; i < 8; i++)
        v = (v << 1) | model->get_bit(mkey(K_PCM, i), 0);
      buf[k] = (uint8_t)v;
    }
    enc.pcm_bytes(buf.data(), buf.size());
  }

  // compress primitives
  int raw_bin(int ctx) {
    int b = xc->decision(states, ctx);
    n_bins++;
    return b;
  }
  int raw_bypass() {
    int b = xc->bypass();
    n_bins++;
    return b;
  }
  int raw_terminate() {
    int b = xc->terminate();
    n_bins++;
    if (__builtin_expect(ref != nullptr, 0)) ref->terminate_bin(b);
    return b;
  }
  // decompress primitives
  void put_raw_bin(int ctx, int b) { enc.decision(states, ctx, b); }
  void put_terminate(int b) { enc.terminate(b); }

  // per-class original-CABAC bit ledger (the "CABAC Bill"): bits consumed
  // from the payload per element class (caller-provided uint64[K_NCLS])
  uint64_t* cabac_bill = nullptr;
  size_t bill_anchor = 0;

  void bill_mark(uint32_t cls) {
    if (!cabac_bill) return;
    size_t p = xc->bitpos();
    cabac_bill[cls] += p - bill_anchor;
    bill_anchor = p;
  }

  // unified modeled bin.  Compress order matters for throughput: the model
  // probability (cell load -> divtab -> mix) is prepared BEFORE the CABAC
  // decode so the two serial dependency chains overlap (model.h::prepare).
  int bin(int ctx, uint64_t key) {
    if (is_compress) {
#ifdef AVT_AB_NOMODEL
      return raw_bin(ctx);
#endif
      int pcab = cabac_p1(ctx);  // read BEFORE decision updates states
      if (model && model->deferred()) {  // two-pass: record only (pass A)
        int b = raw_bin(ctx);
        if (__builtin_expect(cabac_bill != nullptr, 0))
          bill_mark((uint32_t)(key >> 40));
        if (__builtin_expect(ref != nullptr, 0)) ref->ctx_bin(ctx, b);
        if (__builtin_expect(mix != nullptr, 0)) mix->on_bin(key, pcab, b);
        model->put_bit(key, b, pcab);
        return b;
      }
      RecodeModel::Prep pp;
      if (model) pp = model->prepare(key, pcab);
      int b = raw_bin(ctx);
      if (__builtin_expect(cabac_bill != nullptr, 0))
        bill_mark((uint32_t)(key >> 40));
      if (__builtin_expect(ref != nullptr, 0)) ref->ctx_bin(ctx, b);
      if (__builtin_expect(mix != nullptr, 0)) mix->on_bin(key, pcab, b);
      if (model) model->commit(pp, key, b);
      return b;
    }
    int b = model->get_bit(key, cabac_p1(ctx));
    enc.decision(states, ctx, b);
    return b;
  }
  int bypass(uint64_t key) {
    if (is_compress) {
#ifdef AVT_AB_NOMODEL
      return raw_bypass();
#endif
      if (model && model->deferred()) {  // two-pass: record only (pass A)
        int b = raw_bypass();
        if (__builtin_expect(cabac_bill != nullptr, 0))
          bill_mark((uint32_t)(key >> 40));
        if (__builtin_expect(ref != nullptr, 0)) ref->bypass_bin(b);
        if (__builtin_expect(mix != nullptr, 0)) mix->on_bin(key, 0, b);
        model->put_bit(key, b, 0);
        return b;
      }
      RecodeModel::Prep pp;
      if (model) pp = model->prepare(key, 0);
      int b = raw_bypass();
      if (__builtin_expect(cabac_bill != nullptr, 0))
        bill_mark((uint32_t)(key >> 40));
      if (__builtin_expect(ref != nullptr, 0)) ref->bypass_bin(b);
      if (__builtin_expect(mix != nullptr, 0)) mix->on_bin(key, 0, b);
      if (model) model->commit(pp, key, b);
      return b;
    }
    int b = model->get_bit(key, 0);
    enc.bypass(b);
    return b;
  }

  // verify: (ok, drop, tail) against original payload (coders.verify_tail)
  bool verify_tail(int* drop, Bytes* tail) const {
    const Bytes& out = xc->bytes();
    size_t n = std::min(out.size(), payload_size);
    size_t common = 0;
    while (common < n && out[common] == payload[common]) common++;
    if (out.size() > payload_size || common + 1 < out.size()) return false;
    *drop = (int)(out.size() - common);
    tail->assign(payload + common, payload + payload_size);
    return true;
  }
};

class SliceParser {
 public:
  SliceParser(const SPS& sps, const PPS& pps, const SliceHeader& hdr,
              PicState* pic, const PicState* prev, Coder* c, int sid,
              bool isolate)
      : sps_(sps), pps_(pps), hdr_(hdr), pic_(pic), prev_(prev), c_(c),
        sid_(sid), isolate_(isolate), W_(sps.pic_width_in_mbs),
        H_(mb_height(sps) >> (hdr.field_pic ? 1 : 0)) {
    mbaff_ = hdr.mbaff;
    // PAFF field picture: a half-height picture whose MBs are ALL
    // field-coded — plain raster addressing/neighbors, field context rows
    // (mbparse.py mirror)
    field_pic_ = hdr.field_pic;
    if (field_pic_) cur_field_ = 1;
    // SP slices parse exactly like P (7.3.5); SI keeps its own type for
    // the mb_type prefix bin and the absent skip flag (mbparse.py mirror)
    stype_ = hdr.slice_type == SLICE_SP ? SLICE_P : hdr.slice_type;
    nref0_ = hdr.num_ref_idx_l0_active;
    nref1_ = hdr.num_ref_idx_l1_active;
    ch422_ = sps.chroma_format_idc == 2;
    // ChromaArrayType semantics (7.4.2.1.1): separate colour planes code
    // each plane as a monochrome picture (ChromaArrayType 0)
    ch444_ = sps.chroma_format_idc == 3 && !sps.separate_colour_plane_flag;
    // monochrome (ChromaArrayType 0): no chroma planes — no chroma pred
    // mode, no chroma cbp bins, luma-only residuals (mbparse.py mirror)
    ch400_ = sps.chroma_format_idc == 0 ||
             sps.separate_colour_plane_flag != 0;
    ch_grid_h_ = ch422_ ? 4 : 2;
    n_chroma_ac_ = ch422_ ? 8 : 4;
  }

  // compress: mb_count < 0 (discovered); decompress: from container
  int parse_slice_data(int mb_count) {
    if (mbaff_) return parse_slice_data_mbaff(mb_count);
    int addr = hdr_.first_mb_in_slice;
    int n = 0;
    int total = W_ * H_;
    for (;;) {
      if (addr >= total) throw Desync("mb address beyond picture");
      mbx_ = addr % W_;
      mby_ = addr / W_;
      parse_macroblock();
      n++;
      int eos;
      if (mb_count < 0) {
        eos = c_->raw_terminate();
      } else {
        eos = n == mb_count ? 1 : 0;
        c_->put_terminate(eos);
      }
      if (eos) break;
      addr++;
    }
    return n;
  }

  // MBAFF slice loop (7.3.4): addresses walk MB pairs; the field flag sits
  // between the skip flag(s) and the first non-skipped MB layer;
  // end_of_slice_flag appears only after bottom MBs (mbparse.py mirror)
  int parse_slice_data_mbaff(int mb_count) {
    int pair = hdr_.first_mb_in_slice;
    int n = 0;
    int total_pairs = W_ * (H_ >> 1);
    for (;;) {
      if (pair >= total_pairs) throw Desync("mb pair address beyond picture");
      int px = pair % W_, py = pair / W_;
      field_known_ = false;
      if (px == 0 && pair != hdr_.first_mb_in_slice) {
        // pair-row wrap: reseed the provisional register with the 7.4.4
        // inference (predict_field_decoding_flag in the row-advance path)
        mbx_ = px;
        mby_ = 2 * py + 1;
        eff_field_ = predict_field();
      }
      cur_field_ = eff_field_;  // provisional (stale register)
      size_t pair_bins0 = c_->recorded();
      bool top_skipped = false;
      for (int bottom = 0; bottom < 2; bottom++) {
        mbx_ = px;
        mby_ = 2 * py + bottom;
        bool skipped = parse_macroblock();
        if (bottom == 0) {
          top_skipped = skipped;
        } else if (skipped && top_skipped && !field_known_) {
          // both skipped: 7.4.4 inference, applied retroactively
          cur_field_ = eff_field_ = predict_field();
          field_known_ = true;
          pic_->field[mb(mbx_, mby_ - 1)] = (uint8_t)cur_field_;
          pic_->field[mb(mbx_, mby_)] = (uint8_t)cur_field_;
        }
        n++;
      }
      if (cur_field_) field_bins_ += c_->recorded() - pair_bins0;
      int eos;
      if (mb_count < 0) {
        eos = c_->raw_terminate();
      } else {
        eos = n == mb_count ? 1 : 0;
        c_->put_terminate(eos);
      }
      if (eos) break;
      pair++;
    }
    return n;
  }

  // pass A's bins in the MB pairs decoded as fields (MBAFF), counted at
  // the end of each pair
  uint64_t field_bins() const { return field_bins_; }

 private:
  // -- availability ----------------------------------------------------
  bool avail(int x, int y) const {
    if (x < 0 || y < 0 || x >= W_ || y >= H_) return false;
    return pic_->slice_id[(size_t)y * W_ + x] == sid_;
  }
  size_t mb(int x, int y) const { return (size_t)y * W_ + x; }

  int bin(int ctx, uint64_t key) { return c_->bin(ctx, key); }
  int bypass(uint64_t key) { return c_->bypass(key); }

  // neighbor 4x4 blk: returns nmbx,nmby,nblk
  void blk4_neighbor(int blk, int dx, int dy, int* nmbx, int* nmby,
                     int* nblk) const {
    int x = G.blk4_x[blk] + dx, y = G.blk4_y[blk] + dy;
    *nmbx = mbx_;
    *nmby = mby_;
    if (x < 0) { (*nmbx)--; x += 4; } else if (x > 3) { (*nmbx)++; x -= 4; }
    if (y < 0) { (*nmby)--; y += 4; } else if (y > 3) { (*nmby)++; y -= 4; }
    *nblk = G.raster_to_blk4[y * 4 + x];
  }
  void chroma_neighbor(int blk, int dx, int dy, int* nmbx, int* nmby,
                       int* nblk) const {
    int gh = ch_grid_h_;
    int x = (blk & 1) + dx, y = (blk >> 1) + dy;
    *nmbx = mbx_;
    *nmby = mby_;
    if (x < 0) { (*nmbx)--; x += 2; } else if (x > 1) { (*nmbx)++; x -= 2; }
    if (y < 0) { (*nmby)--; y += gh; } else if (y > gh - 1) { (*nmby)++; y -= gh; }
    *nblk = y * 2 + x;
  }

  // -- MBAFF neighbor derivation (mbparse.py::_mbaff_neighbors; the hooked
  // decoder's fill_decode_neighbors semantics: left pair splits into
  // (LTOP, LBOT) for current 4x4 rows 0-1 / 2-3 with a per-row y remap) --
  int field_at(int x, int y) const {
    if (x < 0 || y < 0 || x >= W_ || y >= H_) return 0;
    return pic_->field[mb(x, y)];
  }
  void mbaff_neighbors() {
    int x = mbx_, y = mby_, f = cur_field_, bottom = y & 1;
    if (!f) {
      top_xy_[0] = x; top_xy_[1] = y - 1;
    } else {
      top_xy_[0] = x; top_xy_[1] = y - 2;
      if (!bottom && !field_at(x, y - 2)) top_xy_[1] = y - 1;
    }
    int lx = x - 1;
    left_xy_[0][0] = left_xy_[1][0] = lx;
    left_xy_[0][1] = left_xy_[1][1] = y;
    left_ymap_[0] = 0; left_ymap_[1] = 1; left_ymap_[2] = 2; left_ymap_[3] = 3;
    auto set_map = [&](int a, int b, int c, int d) {
      left_ymap_[0] = a; left_ymap_[1] = b; left_ymap_[2] = c; left_ymap_[3] = d;
    };
    if (lx >= 0 && field_at(lx, y) != f) {
      if (bottom) {
        if (f) { left_xy_[0][1] = y - 1; set_map(0, 2, 0, 2); }
        else   { left_xy_[0][1] = left_xy_[1][1] = y - 1; set_map(2, 2, 3, 3); }
      } else {
        if (f) { left_xy_[1][1] = y + 1; set_map(0, 2, 0, 2); }
        else   { set_map(0, 0, 1, 1); }
      }
    }
  }
  // MB-level left/up neighbors for ctx derivation
  void mb_left(int* x, int* y) const {
    if (mbaff_) { *x = left_xy_[0][0]; *y = left_xy_[0][1]; }
    else { *x = mbx_ - 1; *y = mby_; }
  }
  void mb_up(int* x, int* y) const {
    if (mbaff_) { *x = top_xy_[0]; *y = top_xy_[1]; }
    else { *x = mbx_; *y = mby_ - 1; }
  }
  // 4x4 luma neighbor (left/up single step), MBAFF-aware
  void blk_nb(int blk, int dx, int dy, int* nmbx, int* nmby, int* nblk) const {
    if (!mbaff_) return blk4_neighbor(blk, dx, dy, nmbx, nmby, nblk);
    int x4 = G.blk4_x[blk] + dx, y4 = G.blk4_y[blk] + dy;
    if (x4 >= 0 && x4 <= 3 && y4 >= 0 && y4 <= 3) {
      *nmbx = mbx_; *nmby = mby_;
      *nblk = G.raster_to_blk4[y4 * 4 + x4];
      return;
    }
    if (x4 < 0) {
      *nmbx = left_xy_[y4 >> 1][0]; *nmby = left_xy_[y4 >> 1][1];
      *nblk = G.raster_to_blk4[left_ymap_[y4] * 4 + 3];
      return;
    }
    *nmbx = top_xy_[0]; *nmby = top_xy_[1];  // y4 < 0
    *nblk = G.raster_to_blk4[3 * 4 + x4];
  }
  void chroma_nb(int blk, int dx, int dy, int* nmbx, int* nmby, int* nblk) const {
    if (!mbaff_) return chroma_neighbor(blk, dx, dy, nmbx, nmby, nblk);
    int gh = ch_grid_h_;
    int xc = (blk & 1) + dx, yc = (blk >> 1) + dy;
    if (xc >= 0 && xc <= 1 && yc >= 0 && yc < gh) {
      *nmbx = mbx_; *nmby = mby_;
      *nblk = yc * 2 + xc;
      return;
    }
    if (xc < 0) {
      int r = yc * 4 / gh;  // luma-equivalent row
      *nmbx = left_xy_[r >> 1][0]; *nmby = left_xy_[r >> 1][1];
      *nblk = (left_ymap_[r] * gh / 4) * 2 + 1;
      return;
    }
    *nmbx = top_xy_[0]; *nmby = top_xy_[1];  // yc < 0
    *nblk = (gh - 1) * 2 + xc;
  }

  // -- element parsers (mbparse.py mirrors) ----------------------------
  int parse_mb_skip() {
    int base = stype_ == SLICE_P ? 11 : 24;
    int ax, ay, bx, by;
    if (mbaff_) {
      // hooked decoder's decode_cabac_mb_skip: neighbors from the pair-top
      // address using the not-yet-overwritten flag register (eff_field_)
      int x = mbx_, y = mby_, py = y & ~1;
      ax = x - 1; ay = py;
      if ((y & 1) && avail(ax, ay) && eff_field_ == field_at(ax, ay)) ay = py + 1;
      if (eff_field_) {
        bx = x; by = py - 1;
        if (!(y & 1) && avail(bx, by) && field_at(bx, by)) by = py - 2;
      } else {
        bx = x; by = y - 1;
      }
    } else {
      ax = mbx_ - 1; ay = mby_;
      bx = mbx_; by = mby_ - 1;
    }
    int inc = 0;
    if (avail(ax, ay) && !pic_->skip[mb(ax, ay)]) inc++;
    if (avail(bx, by) && !pic_->skip[mb(bx, by)]) inc++;
    return bin(base + inc, mkey(K_SKIP, stype_, inc));
  }

  // MBAFF mb_field_decoding_flag (ctx 70-72, 9.3.3.1.1.2): left term is the
  // previous pair's flag register (mb_x > 0 only), above term the above
  // pair's stored flag gated on slice membership
  int parse_field_flag() {
    int inc = mbx_ > 0 ? eff_field_ : 0;
    int ay = (mby_ & ~1) - 2;
    if (ay >= 0 && pic_->slice_id[mb(mbx_, ay)] == sid_ &&
        pic_->field[mb(mbx_, ay)])
      inc++;
    return bin(70 + inc, mkey(K_FIELDF, inc));
  }

  // 7.4.4 inference for a both-skipped pair / row-wrap register reseed
  int predict_field() const {
    int x = mbx_, ty = mby_ & ~1;
    const int nx[2] = {x - 1, x}, ny[2] = {ty, ty - 1};
    for (int k = 0; k < 2; k++) {
      if (nx[k] >= 0 && ny[k] >= 0 && nx[k] < W_ && ny[k] < H_ &&
          pic_->slice_id[mb(nx[k], ny[k])] == sid_)
        return pic_->field[mb(nx[k], ny[k])];
    }
    return 0;
  }

  struct I16Info { int cbf_luma, cbp_chroma, pred; bool pcm; };

  I16Info parse_mb_type_i_suffix(int base, bool intra_slice) {
    int skew = intra_slice ? 2 : 0;
    I16Info r{};
    if (c_->pcm_flag()) {
      r.pcm = true;  // I_PCM escape (Table 9-36 bin string "11")
      return r;
    }
    r.cbf_luma = bin(base + skew + 1, mkey(K_I16CBF));
    r.cbp_chroma = 0;
    // model v9: neighbor cbp_chroma context (3 = unavailable) — the CABAC
    // contexts for the I16 suffix are fixed, so the model supplies the
    // spatial conditioning CABAC lacks (mbparse.parse_mb_type_i_suffix)
    int nx, ny, ca = 3, cb = 3;
    mb_left(&nx, &ny);
    if (avail(nx, ny)) ca = pic_->cbp_chroma[mb(nx, ny)];
    mb_up(&nx, &ny);
    if (avail(nx, ny)) cb = pic_->cbp_chroma[mb(nx, ny)];
    if (bin(base + skew + 2, mkey(K_I16CBC0, ca, cb)))
      r.cbp_chroma = 1 + bin(base + skew + (intra_slice ? 3 : 2),
                             mkey(K_I16CBC1, ca == 2, cb == 2));
    int pm1 = bin(base + skew + (intra_slice ? 4 : 3), mkey(K_I16PM1));
    int pm0 = bin(base + skew + (intra_slice ? 5 : 3), mkey(K_I16PM0));
    r.pred = 2 * pm1 + pm0;
    return r;
  }

  // returns mbclass; fills i16/pinfo/btype
  MbClass parse_mb_type(I16Info* i16, int* p_kind, int* b_type) {
    PicState* p = pic_;
    if (stype_ == SLICE_SI) {
      // SI mb_type (9.3.2.5, Table 9-11 ctxIdxOffset 0): prefix bin 0 ->
      // SI macroblock; 1 -> the full I-slice binarization.  Prefix ctxInc
      // per 9.3.3.1.1.3: neighbors counted unless SI (mbparse.py mirror).
      int lxx, lyy, uxx, uyy;
      mb_left(&lxx, &lyy);
      mb_up(&uxx, &uyy);
      int inc = 0;
      if (avail(lxx, lyy) && p->mbclass[mb(lxx, lyy)] != MB_SI) inc++;
      if (avail(uxx, uyy) && p->mbclass[mb(uxx, uyy)] != MB_SI) inc++;
      if (!bin(0 + inc, mkey(K_SIMBTYPE, inc))) return MB_SI;
      int inc2 = 0;
      if (avail(lxx, lyy) && p->mbclass[mb(lxx, lyy)] != MB_I_NXN) inc2++;
      if (avail(uxx, uyy) && p->mbclass[mb(uxx, uyy)] != MB_I_NXN) inc2++;
      if (!bin(3 + inc2, mkey(K_IMBTYPE, inc2))) return MB_I_NXN;
      *i16 = parse_mb_type_i_suffix(3, true);
      return i16->pcm ? MB_I_PCM : MB_I16;
    }
    if (stype_ == SLICE_I) {
      int lxx, lyy, uxx, uyy;
      mb_left(&lxx, &lyy);
      mb_up(&uxx, &uyy);
      int inc = 0;
      if (avail(lxx, lyy) && p->mbclass[mb(lxx, lyy)] != MB_I_NXN) inc++;
      if (avail(uxx, uyy) && p->mbclass[mb(uxx, uyy)] != MB_I_NXN) inc++;
      if (!bin(3 + inc, mkey(K_IMBTYPE, inc))) return MB_I_NXN;
      *i16 = parse_mb_type_i_suffix(3, true);
      return i16->pcm ? MB_I_PCM : MB_I16;
    }
    if (stype_ == SLICE_P) {
      int inc2 = 0;
      for (int k = 0; k < 2; k++) {
        int nx, ny;
        if (k == 0) mb_left(&nx, &ny); else mb_up(&nx, &ny);
        if (avail(nx, ny)) {
          uint8_t cls = p->mbclass[mb(nx, ny)];
          if (cls == MB_I_NXN || cls == MB_I16 || cls == MB_I_PCM ||
              cls == MB_SI)
            inc2 += k == 0 ? 1 : 2;
        }
      }
      if (bin(14, mkey(K_PMBTYPE0, inc2))) {
        if (!bin(17, mkey(K_PMBTYPE_INTRA))) return MB_I_NXN;
        *i16 = parse_mb_type_i_suffix(17, false);
        return i16->pcm ? MB_I_PCM : MB_I16;
      }
      if (!bin(15, mkey(K_PMBTYPE1))) {
        *p_kind = bin(16, mkey(K_PMBTYPE2A)) ? 3 : 0;  // P8x8 : P16x16
      } else {
        *p_kind = bin(17, mkey(K_PMBTYPE2B)) ? 1 : 2;  // P16x8 : P8x16
      }
      return MB_INTER;
    }
    // B slice
    int inc = 0;
    for (int k = 0; k < 2; k++) {
      int nx, ny;
      if (k == 0) mb_left(&nx, &ny); else mb_up(&nx, &ny);
      if (avail(nx, ny)) {
        uint8_t cls = pic_->mbclass[mb(nx, ny)];
        if (cls != MB_B_SKIP && cls != MB_B_DIRECT) inc++;
      }
    }
    if (!bin(27 + inc, mkey(K_BMBTYPE0, inc))) return MB_B_DIRECT;
    if (!bin(30, mkey(K_BMBTYPE1))) {
      *b_type = 1 + bin(32, mkey(K_BMBTYPE2));
      return MB_INTER;
    }
    int v = bin(31, mkey(K_BMBTYPE3)) << 3;
    v |= bin(32, mkey(K_BMBTYPE4)) << 2;
    v |= bin(32, mkey(K_BMBTYPE5)) << 1;
    v |= bin(32, mkey(K_BMBTYPE6));
    if (v < 8) { *b_type = v + 3; return MB_INTER; }
    if (v == 13) {
      if (!bin(32, mkey(K_BMBTYPE_INTRA))) return MB_I_NXN;
      *i16 = parse_mb_type_i_suffix(32, false);
      return i16->pcm ? MB_I_PCM : MB_I16;
    }
    if (v == 14) { *b_type = 11; return MB_INTER; }
    if (v == 15) { *b_type = 22; return MB_INTER; }
    *b_type = (((v - 8) << 1) | bin(32, mkey(K_BMBTYPE7))) + 12;
    return MB_INTER;
  }

  int parse_sub_mb_type_p() {
    if (bin(21, mkey(K_PSUB0))) return 0;
    if (!bin(22, mkey(K_PSUB1))) return 1;
    return bin(23, mkey(K_PSUB2)) ? 2 : 3;
  }
  int parse_sub_mb_type_b() {
    if (!bin(36, mkey(K_BSUB0))) return 0;
    if (!bin(37, mkey(K_BSUB1))) return 1 + bin(39, mkey(K_BSUB2));
    int t = 3;
    if (bin(38, mkey(K_BSUB3))) {
      if (bin(39, mkey(K_BSUB4))) return 11 + bin(39, mkey(K_BSUB5));
      t += 4;
    }
    t += 2 * bin(39, mkey(K_BSUB6));
    t += bin(39, mkey(K_BSUB7));
    return t;
  }

  int parse_transform_8x8() {
    int lxx, lyy, uxx, uyy;
    mb_left(&lxx, &lyy);
    mb_up(&uxx, &uyy);
    int inc = 0;
    if (avail(lxx, lyy) && pic_->t8x8[mb(lxx, lyy)]) inc++;
    if (avail(uxx, uyy) && pic_->t8x8[mb(uxx, uyy)]) inc++;
    return bin(399 + inc, mkey(K_T8X8, inc));
  }

  void parse_intra_pred_modes(int n_blocks) {
    for (int i = 0; i < n_blocks; i++)
      if (!bin(68, mkey(K_IPREDF)))
        for (int j = 0; j < 3; j++) bin(69, mkey(K_IPREDR, j));
  }

  int parse_chroma_pred_mode() {
    int inc = 0;
    for (int k = 0; k < 2; k++) {
      int nx, ny;
      if (k == 0) mb_left(&nx, &ny); else mb_up(&nx, &ny);
      if (avail(nx, ny)) {
        uint8_t cls = pic_->mbclass[mb(nx, ny)];
        if ((cls == MB_I_NXN || cls == MB_I16 || cls == MB_SI) &&
            pic_->chroma_mode[mb(nx, ny)])
          inc++;
      }
    }
    if (!bin(64 + inc, mkey(K_CPRED0, inc))) return 0;
    if (!bin(67, mkey(K_CPRED1))) return 1;
    return 2 + bin(67, mkey(K_CPRED2));
  }

  void parse_cbp(int* cbp_luma, int* cbp_chroma, int intra) {
    PicState* p = pic_;
    int lxx, lyy, uxx, uyy;
    mb_left(&lxx, &lyy);
    mb_up(&uxx, &uyy);
    bool aa = avail(lxx, lyy), ab = avail(uxx, uyy);
    int cbp = 0;
    for (int i8 = 0; i8 < 4; i8++) {
      int x8 = i8 & 1, y8 = i8 >> 1;
      int cond_a, cond_b;
      if (x8 == 0) {
        if (aa) {
          if (mbaff_) {
            // row y8's left 8x8 lives in left_xy[y8] at the remapped row
            size_t la = mb(left_xy_[y8][0], left_xy_[y8][1]);
            int lb = (left_ymap_[2 * y8] >> 1) * 2 + 1;
            cond_a = ((p->cbp_luma[la] >> lb) & 1) ? 0 : 1;
          } else {
            cond_a = ((p->cbp_luma[mb(lxx, lyy)] >> (y8 * 2 + 1)) & 1) ? 0 : 1;
          }
        } else {
          cond_a = 0;
        }
      } else {
        cond_a = ((cbp >> (y8 * 2)) & 1) ? 0 : 1;
      }
      if (y8 == 0)
        cond_b = ab ? (((p->cbp_luma[mb(uxx, uyy)] >> (2 + x8)) & 1) ? 0 : 1) : 0;
      else
        cond_b = ((cbp >> x8) & 1) ? 0 : 1;
      if (bin(73 + cond_a + 2 * cond_b, mkey(K_CBPL, i8, cond_a + 2 * cond_b, intra)))
        cbp |= 1 << i8;
    }
    if (ch444_ || ch400_) {  // no chroma cbp bins (4:4:4 applies luma
                             // bits per plane; 4:0:0 has none)
      *cbp_luma = cbp;
      *cbp_chroma = 0;
      return;
    }
    int cond_a = (aa && p->cbp_chroma[mb(lxx, lyy)] != 0) ? 1 : 0;
    int cond_b = (ab && p->cbp_chroma[mb(uxx, uyy)] != 0) ? 1 : 0;
    int cbp_c = 0;
    if (bin(77 + cond_a + 2 * cond_b, mkey(K_CBPC0, cond_a + 2 * cond_b))) {
      cond_a = (aa && p->cbp_chroma[mb(lxx, lyy)] == 2) ? 1 : 0;
      cond_b = (ab && p->cbp_chroma[mb(uxx, uyy)] == 2) ? 1 : 0;
      cbp_c = 1 + bin(81 + cond_a + 2 * cond_b, mkey(K_CBPC1, cond_a + 2 * cond_b));
    }
    *cbp_luma = cbp;
    *cbp_chroma = cbp_c;
  }

  void parse_mb_qp_delta() {
    if (!bin(60 + prev_qp_delta_nz_, mkey(K_QPD0, prev_qp_delta_nz_))) {
      prev_qp_delta_nz_ = 0;
      prev_qp_mag_ = 0;
      return;
    }
    int v = 1;
    // model v9: previous nonzero |qp_delta| mapped-unary magnitude as a
    // key context (model state, sticky across the spec's skip/PCM
    // qp-context resets; mbparse.parse_mb_qp_delta mirror)
    int pm = prev_qp_mag_;
    if (bin(62, mkey(K_QPD1, pm))) {
      v = 2;
      while (bin(63, mkey(K_QPD2, std::min(v - 2, 4), pm))) {
        if (++v > 128) throw Unsupported("qp_delta overflow");
      }
    }
    prev_qp_delta_nz_ = 1;
    prev_qp_mag_ = std::min(v, 7);
  }

  // active ref count for ref_idx presence: field MBs address per-field
  // lists with twice the entries (7.4.3 / ref_count << MB_MBAFF)
  int nref_eff(int lst) const {
    int n = lst == 0 ? nref0_ : nref1_;
    return (mbaff_ && cur_field_) ? n << 1 : n;
  }

  int parse_ref_idx(int lst, int blk) {
    int inc = 0;
    static const int dxs[2] = {-1, 0}, dys[2] = {0, -1};
    for (int k = 0; k < 2; k++) {
      int nmbx, nmby, nblk;
      blk_nb(blk, dxs[k], dys[k], &nmbx, &nmby, &nblk);
      if (avail(nmbx, nmby)) {
        int quad = (G.blk4_y[nblk] >> 1) * 2 + (G.blk4_x[nblk] >> 1);
        int r = pic_->refidx[((size_t)lst * H_ * W_ + mb(nmbx, nmby)) * 4 + quad];
        if (mbaff_ && r > 0) {
          // parity rescale (9.3.3.1.1.6): field refs are per-field
          int nf = field_at(nmbx, nmby);
          if (cur_field_ && !nf) r <<= 1;
          else if (!cur_field_ && nf) r >>= 1;
        }
        if (r > 0) inc += k == 0 ? 1 : 2;
      }
    }
    int v = 0;
    static const int ctxs[3] = {0, 58, 59};
    for (;;) {
      int ctx = v == 0 ? 54 + inc : ctxs[std::min(v, 2)];
      if (!bin(ctx, mkey(K_REF, std::min(v, 2), v == 0 ? inc : 0))) break;
      if (++v > 32) throw Unsupported("ref_idx overflow");
    }
    return v;
  }

  int parse_mvd(int lst, int blk, int comp) {
    int base = comp == 0 ? 40 : 47;
    int s = 0;
    static const int dxs[2] = {-1, 0}, dys[2] = {0, -1};
    for (int k = 0; k < 2; k++) {
      int nmbx, nmby, nblk;
      blk_nb(blk, dxs[k], dys[k], &nmbx, &nmby, &nblk);
      if (avail(nmbx, nmby)) {
        int v = pic_->mvd[(((size_t)lst * H_ * W_ + mb(nmbx, nmby)) * 16 + nblk) * 2 + comp];
        if (comp == 1 && mbaff_) {
          // vertical |mvd| parity rescale (9.3.3.1.1.7); the 66 storage
          // clamp below keeps this classification-exact under halving
          int nf = field_at(nmbx, nmby);
          if (cur_field_ && !nf) v >>= 1;
          else if (!cur_field_ && nf) v <<= 1;
        }
        s += v;
      }
    }
    int inc = s < 3 ? 0 : (s <= 32 ? 1 : 2);
    if (!bin(base + inc, mkey(K_MVD, comp, inc))) return 0;
    int v = 1;
    static const int ctx_off[8] = {3, 4, 5, 6, 6, 6, 6, 6};
    while (v < 9 && bin(base + ctx_off[v - 1], mkey(K_MVDP, comp, std::min(v, 5))))
      v++;
    if (v == 9) {
      int k = 3;
      while (bypass(mkey(K_MVDE, comp, std::min(k - 3, 5)))) {
        v += 1 << k;
        if (++k > 30) throw Unsupported("mvd overflow");
      }
      while (k--) v += bypass(mkey(K_MVDB, comp, std::min(k, 7))) << k;
    }
    int sign = bypass(mkey(K_MVDS, comp));
    return sign ? -v : v;
  }

  void store_mvd(int lst, int blk, int w4, int h4, int vx, int vy) {
    int x0 = G.blk4_x[blk], y0 = G.blk4_y[blk];
    for (int yy = y0; yy < y0 + h4; yy++)
      for (int xx = x0; xx < x0 + w4; xx++) {
        int b = G.raster_to_blk4[yy * 4 + xx];
        size_t base = (((size_t)lst * H_ * W_ + mb(mbx_, mby_)) * 16 + b) * 2;
        int ax = vx < 0 ? -vx : vx, ay = vy < 0 ? -vy : vy;
        // clamp 66: preserves the {<3, <=32, >32} sum classification exactly
        // even after the MBAFF halving rescale (66 >> 1 == 33 > 32)
        pic_->mvd[base] = (uint8_t)(ax < 66 ? ax : 66);
        pic_->mvd[base + 1] = (uint8_t)(ay < 66 ? ay : 66);
      }
  }
  void parse_mvd_part(int lst, int blk, int w4, int h4) {
    int vx = parse_mvd(lst, blk, 0);
    int vy = parse_mvd(lst, blk, 1);
    store_mvd(lst, blk, w4, h4, vx, vy);
  }
  void store_ref(int lst, int blk, int w4, int h4, int r) {
    int x0 = G.blk4_x[blk], y0 = G.blk4_y[blk];
    for (int yy = y0; yy < y0 + h4; yy += 2)
      for (int xx = x0; xx < x0 + w4; xx += 2)
        pic_->refidx[((size_t)lst * H_ * W_ + mb(mbx_, mby_)) * 4 +
                     (yy >> 1) * 2 + (xx >> 1)] = (int8_t)r;
  }

  // -- residuals -------------------------------------------------------
  int cbf_neighbor_inc(int cat, int blk, bool is_intra) {
    const PicState* p = pic_;
    int inc = 0;
    static const int dxs[2] = {-1, 0}, dys[2] = {0, -1};
    int plane = (cat == CAT_CHROMA_DC || cat == CAT_CHROMA_AC)
                    ? -1 : kCatPlane[cat];
    for (int di = 0; di < 2; di++) {
      int cond;
      if (cat_is_dc3(cat) || cat == CAT_CHROMA_DC) {
        int nx, ny;
        if (dxs[di]) mb_left(&nx, &ny); else mb_up(&nx, &ny);
        if (!avail(nx, ny))
          cond = is_intra ? 1 : 0;
        else if (cat == CAT_LUMA_DC)
          cond = p->cbf_luma_dc[mb(nx, ny)];
        else if (cat == CAT_CHROMA_DC)
          cond = p->cbf_chroma_dc[mb(nx, ny) * 2 + blk];
        else  // 4:4:4 Cb/Cr DC: per-plane map
          cond = p->cbf_chroma_dc[mb(nx, ny) * 2 + plane - 1];
      } else if (cat == CAT_CHROMA_AC) {
        int comp = blk >> 3, sub = blk & 7;
        int nmbx, nmby, nsub;
        chroma_nb(sub, dxs[di], dys[di], &nmbx, &nmby, &nsub);
        if (!avail(nmbx, nmby))
          cond = is_intra ? 1 : 0;
        else
          cond = p->cbf_chroma_ac[mb(nmbx, nmby) * 16 + comp * 8 + nsub];
      } else {
        int nmbx, nmby, nblk;
        blk_nb(blk, dxs[di], dys[di], &nmbx, &nmby, &nblk);
        if (!avail(nmbx, nmby))
          cond = is_intra ? 1 : 0;
        else if (cat_is_88(cat) && !p->t8x8[mb(nmbx, nmby)])
          // 4:4:4 8x8 cbf ctx: a neighbor not coded with the 8x8 transform
          // contributes 0 — oracle-validated against x264 output
          cond = 0;
        else if (plane == 0)
          cond = p->cbf_luma[mb(nmbx, nmby) * 16 + nblk];
        else
          cond = p->cbf_c44[((size_t)(plane - 1) * H_ * W_ + mb(nmbx, nmby)) * 16 + nblk];
      }
      inc += cond << di;
    }
    return inc;
  }

  // model v8: left/above DC-sign context for a block's first coefficient —
  // 3*(L+1)+(A+1), each neighbor sign in {-1,0,+1} (0 = unavailable,
  // uncoded, or zero DC).  Mirrors mbparse._sgn_neighbor exactly.
  int sgn_neighbor(int cat, int blk) {
    const PicState* p = pic_;
    static const int dxs[2] = {-1, 0}, dys[2] = {0, -1};
    int plane = cat == CAT_CHROMA_DC ? -1 : kCatPlane[cat];
    int v[2] = {0, 0};
    for (int di = 0; di < 2; di++) {
      if (cat_is_dc3(cat)) {
        int nx, ny;
        if (dxs[di]) mb_left(&nx, &ny); else mb_up(&nx, &ny);
        if (!avail(nx, ny)) continue;
        v[di] = cat == CAT_LUMA_DC
                    ? p->sgn_luma_dc[mb(nx, ny)]
                    : p->sgn_chroma_dc[mb(nx, ny) * 2 + plane - 1];
      } else if (cat == CAT_CHROMA_DC) {
        int nx, ny;
        if (dxs[di]) mb_left(&nx, &ny); else mb_up(&nx, &ny);
        if (avail(nx, ny)) v[di] = p->sgn_chroma_dc[mb(nx, ny) * 2 + blk];
      } else {  // luma-style 4x4/8x8 cells
        int nmbx, nmby, nblk;
        blk_nb(blk, dxs[di], dys[di], &nmbx, &nmby, &nblk);
        if (!avail(nmbx, nmby)) continue;
        v[di] = plane == 0
                    ? p->sgn_luma[mb(nmbx, nmby) * 16 + nblk]
                    : p->sgn_c44[((size_t)(plane - 1) * H_ * W_ +
                                  mb(nmbx, nmby)) * 16 + nblk];
      }
    }
    return 3 * (v[0] + 1) + (v[1] + 1);
  }

  // record a block's DC sign for successors' contexts (8x8 blocks
  // replicate into their four 4x4 cells, like nnz)
  void sgn_store(int cat, int blk, int s0) {
    PicState* p = pic_;
    size_t m = mb(mbx_, mby_);
    if (cat == CAT_LUMA_DC) {
      p->sgn_luma_dc[m] = (int8_t)s0;
    } else if (cat_is_dc3(cat)) {
      p->sgn_chroma_dc[m * 2 + kCatPlane[cat] - 1] = (int8_t)s0;
    } else if (cat == CAT_CHROMA_DC) {
      p->sgn_chroma_dc[m * 2 + blk] = (int8_t)s0;
    } else {
      int plane = kCatPlane[cat];
      int8_t* map = plane == 0
                        ? p->sgn_luma.data()
                        : p->sgn_c44.data() + (size_t)(plane - 1) * H_ * W_ * 16;
      if (cat_is_88(cat)) {
        int x0 = G.blk4_x[blk], y0 = G.blk4_y[blk];
        for (int yy = y0; yy < y0 + 2; yy++)
          for (int xx = x0; xx < x0 + 2; xx++)
            map[m * 16 + G.raster_to_blk4[yy * 4 + xx]] = (int8_t)s0;
      } else {
        map[m * 16 + blk] = (int8_t)s0;
      }
    }
  }

  // walk the sig map with determinism elision (mbparse._replay_sig)
  void replay_sig(int cat, const int* sig_in, int nnz, const int* sig_ctx,
                  const int* last_ctx, int max_coeff, const int* pcabs,
                  int* sig_out, int intra) {
    Coder* c = c_;
    int found = 0;
    for (int i = 0; i < max_coeff; i++) {
      int remaining_pos = max_coeff - i;
      int need = nnz - found;
      int s, det;
      if (i == max_coeff - 1) {
        s = need > 0 ? 1 : 0;
        det = 1;
      } else if (need == 0) {
        s = 0;
        det = 1;
      } else if (need == remaining_pos) {
        s = 1;
        det = 1;
      } else {
        s = -1;
        det = 0;
      }
      uint64_t key =
          mkey(K_SIG, cat + 16 * intra, i, std::min(found, 7), std::min(need, 7));
      if (c->is_compress) {
        int actual = sig_in[i];
        if (det) {
          if (actual != s) throw Desync("sig map det mismatch");
        } else {
          if (__builtin_expect(c->mix != nullptr, 0))
            c->mix->on_bin(key, pcabs[i], actual);
          if (c->model) c->model->put_bit(key, actual, pcabs[i]);
        }
        s = actual;
      } else {
        if (!det) s = c->model->get_bit(key, c->cabac_p1(sig_ctx[i]));
        sig_out[i] = s;
        if (i < max_coeff - 1) c->put_raw_bin(sig_ctx[i], s);
      }
      if (s) {
        found++;
        if (i < max_coeff - 1 && !c->is_compress)
          c->put_raw_bin(last_ctx[i], found == nnz ? 1 : 0);
        if (found == nnz && i < max_coeff - 1) break;
      }
    }
  }

  // reference-scorer geometry: scan8-equivalent sub-block slot + left/above
  // neighbors with PICTURE-bounds-only availability (recode.cpp:426-478
  // get_neighbor_sub_mb checks mb_x/mb_y > 0 only — not slice membership).
  // Slot layout (any self-consistent layout with the same neighbor topology
  // is faithful): luma 4x4 raster 0-15, chroma AC 16 + comp*16 + sub,
  // luma DC 48, chroma DC 49+comp; 8x8 blocks live in their quadrant's
  // top-left 4x4 slot (the reference rounds scan8 down to a multiple of 4)
  void ref_sig_geometry(int cat, int blk, int* slot, RefScorer::Neighbor* L,
                        RefScorer::Neighbor* A) const {
    auto mb_level = [&](int s) {
      *slot = s;
      if (mbx_ > 0) { L->has = true; L->mbx = mbx_ - 1; L->mby = mby_; L->slot = s; }
      if (mby_ > 0) { A->has = true; A->mbx = mbx_; A->mby = mby_ - 1; A->slot = s; }
    };
    switch (cat) {
      case CAT_LUMA_DC: mb_level(48); break;
      case CAT_CHROMA_DC: mb_level(49 + blk); break;
      case CAT_CHROMA_AC: {
        int comp = blk >> 3, sub = blk & 7;
        *slot = 16 + comp * 16 + sub;
        int nmbx, nmby, nsub;
        chroma_neighbor(sub, -1, 0, &nmbx, &nmby, &nsub);
        if (nmbx >= 0) { L->has = true; L->mbx = nmbx; L->mby = nmby;
                         L->slot = 16 + comp * 16 + nsub; }
        chroma_neighbor(sub, 0, -1, &nmbx, &nmby, &nsub);
        if (nmby >= 0) { A->has = true; A->mbx = nmbx; A->mby = nmby;
                         A->slot = 16 + comp * 16 + nsub; }
        break;
      }
      case CAT_LUMA_8x8: {
        int x8 = G.blk4_x[blk] >> 1, y8 = G.blk4_y[blk] >> 1;
        *slot = y8 * 2 * 4 + x8 * 2;
        if (x8 > 0) { L->has = true; L->mbx = mbx_; L->mby = mby_;
                      L->slot = y8 * 2 * 4 + (x8 - 1) * 2; }
        else if (mbx_ > 0) { L->has = true; L->mbx = mbx_ - 1; L->mby = mby_;
                             L->slot = y8 * 2 * 4 + 2; }
        if (y8 > 0) { A->has = true; A->mbx = mbx_; A->mby = mby_;
                      A->slot = (y8 - 1) * 2 * 4 + x8 * 2; }
        else if (mby_ > 0) { A->has = true; A->mbx = mbx_; A->mby = mby_ - 1;
                             A->slot = 2 * 4 + x8 * 2; }
        break;
      }
      default: {  // CAT_LUMA_AC / CAT_LUMA_4x4: 4x4 grid
        int x4 = G.blk4_x[blk], y4 = G.blk4_y[blk];
        *slot = y4 * 4 + x4;
        if (x4 > 0) { L->has = true; L->mbx = mbx_; L->mby = mby_;
                      L->slot = y4 * 4 + x4 - 1; }
        else if (mbx_ > 0) { L->has = true; L->mbx = mbx_ - 1; L->mby = mby_;
                             L->slot = y4 * 4 + 3; }
        if (y4 > 0) { A->has = true; A->mbx = mbx_; A->mby = mby_;
                      A->slot = (y4 - 1) * 4 + x4; }
        else if (mby_ > 0) { A->has = true; A->mbx = mbx_; A->mby = mby_ - 1;
                             A->slot = 3 * 4 + x4; }
        break;
      }
    }
  }

  int parse_residual_block(int cat, int blk, bool is_intra_b, bool has_cbf,
                           int nnz_prior) {
    int is_intra = is_intra_b ? 1 : 0;
    Coder* c = c_;
    // field MBs use the field ctx rows (MBAFF field pairs + PAFF pictures)
    int fld = (mbaff_ || field_pic_) ? cur_field_ : 0;
    int max_coeff = kMaxCoeff[cat];
    if (cat == CAT_CHROMA_DC && ch422_) max_coeff = 8;
    if (has_cbf) {
      int inc = cbf_neighbor_inc(cat, blk, is_intra_b);
      int pq = (cat == CAT_CHROMA_DC || cat_is_dc3(cat))
                   ? 0
                   : (cat == CAT_CHROMA_AC
                          ? (blk & 7) & 3
                          : (G.blk4_y[blk] >> 1) * 2 + (G.blk4_x[blk] >> 1));
      int cbf = bin(kCbfCtxBase[cat] + inc, mkey(K_CBF, cat + 16 * fld, inc + 4 * pq,
                                                 std::min(nnz_prior, 7), is_intra));
      last_cbf_ = cbf;
      if (!cbf) return 0;
    } else {
      last_cbf_ = 1;
    }
    int sig_ctx[64], last_ctx[64];
    if (cat_is_88(cat)) {
      int sig8_base = kSigCoeffOffset[fld * 14 + cat];
      int last8_base = kLastCoeffOffset[fld * 14 + cat];
      for (int i = 0; i < 63; i++) {
        sig_ctx[i] = sig8_base + kSig8x8[fld * 63 + i];  // [2][63] rows
        last_ctx[i] = last8_base + kLast8x8[i];
      }
    } else {
      int sig_base = kSigCoeffOffset[fld * 14 + cat];   // [2][14] rows
      int last_base = kLastCoeffOffset[fld * 14 + cat];
      int numc = ch422_ ? 2 : 1;  // spec: Min(i / NumC8x8, 2)
      for (int i = 0; i < max_coeff - 1; i++) {
        int inc2 = cat == CAT_CHROMA_DC ? std::min(i / numc, 2) : i;
        sig_ctx[i] = sig_base + inc2;
        last_ctx[i] = last_base + inc2;
      }
    }

    int sig[64] = {0};
    int nnz;
    if (c->is_compress) {
      int pcabs[64];
      int n_sig = 0;
      int i;
      for (i = 0; i < max_coeff - 1; i++) {
        pcabs[i] = c->cabac_p1(sig_ctx[i]);
        int s = c->raw_bin(sig_ctx[i]);
        sig[i] = s;
        if (s) {
          n_sig++;
          if (c->raw_bin(last_ctx[i])) break;
        }
      }
      if (i == max_coeff - 1) {
        sig[max_coeff - 1] = 1;  // implicit last position
        n_sig++;
      }
      nnz = n_sig;
      if (__builtin_expect(c->ref != nullptr, 0)) {
        // our Cat enum -> ffmpeg residual category (recode.cpp cat_lookup
        // indexing): luma DC 0, luma AC 1, luma 4x4 2, chroma DC 3,
        // chroma AC 4, luma 8x8 5
        static const int kFfCat[6] = {0, 1, 2, 3, 4, 5};
        int slot;
        RefScorer::Neighbor L, A;
        ref_sig_geometry(cat, blk, &slot, &L, &A);
        int is_dc = cat == CAT_LUMA_DC || cat == CAT_CHROMA_DC;
        int c422 = cat == CAT_CHROMA_DC && ch422_;
        c->ref->sig_block(mbx_, mby_, slot, L, A, kFfCat[cat], max_coeff,
                          is_dc, c422, sig, nnz);
      }
      if (__builtin_expect(c->mix != nullptr, 0))
        c->mix->on_nnz(nnz, cat + 16 * fld, max_coeff, nnz_prior);
      if (c->model) c->model->put_nnz(nnz, cat + 16 * fld, max_coeff, nnz_prior);
      replay_sig(cat, sig, nnz, sig_ctx, last_ctx, max_coeff, pcabs, nullptr,
                 is_intra + 2 * fld);
    } else {
      nnz = c->model->get_nnz(cat + 16 * fld, max_coeff, nnz_prior);
      replay_sig(cat, nullptr, nnz, sig_ctx, last_ctx, max_coeff, nullptr, sig,
                 is_intra + 2 * fld);
    }

    // levels, backward from last significant
    int positions[64], npos = 0;
    for (int i = 0; i < max_coeff; i++)
      if (sig[i]) positions[npos++] = i;
    if (npos != nnz) throw Desync("sig count mismatch");
    int nzb = std::min(nnz, 7);  // block-density bucket for level keys
    int node = 0;
    int abs_base = kAbsLevelOffset[cat];
    int gt1_off = cat == CAT_CHROMA_DC ? 8 : 0;
    int posdiv = cat_is_88(cat) ? 8 : 2;  // scan pos -> 8 buckets
    for (int k = npos - 1; k >= 0; k--) {
      int pb2 = std::min(positions[k] / posdiv, 7);
      int ctx1 = abs_base + kLvl1Ctx[node];
      int coeff = 1;
      if (bin(ctx1, mkey(K_LVL1, cat, kLvl1Ctx[node] + 16 * pb2, is_intra, nzb))) {
        coeff = 2;
        int ctxg = abs_base + kLvlGt1Ctx[gt1_off + node];
        while (coeff < 15 &&
               bin(ctxg, mkey(K_LVLG, cat + 16 * is_intra,
                              kLvlGt1Ctx[gt1_off + node] + 16 * pb2, std::min(coeff, 7),
                              nzb)))
          coeff++;
        if (coeff == 15) {
          int j = 0;
          while (bypass(mkey(K_LVLE, cat, std::min(j, 7)))) {
            if (++j > 30) throw Unsupported("level overflow");
          }
          int add = 1;
          while (j) {
            j--;
            add += add + bypass(mkey(K_LVLB, cat, std::min(j, 7)));
          }
          coeff += add - 1;
        }
        node = kLvlTransition[8 + node];
      } else {
        node = kLvlTransition[node];
      }
      // model v8: true-DC signs (scan position 0 of a DC-bearing
      // category) get a left/above neighbor-sign context
      if (positions[k] == 0 && cat != CAT_LUMA_AC && cat != 7 && cat != 11 &&
          cat != CAT_CHROMA_AC) {
        int nb = sgn_neighbor(cat, blk);
        int sb = bypass(mkey(K_SGN, cat, 0, std::min(coeff, 3), nb));
        sgn_store(cat, blk, sb ? -1 : 1);
      } else {
        bypass(mkey(K_SGN, cat, std::min(positions[k], 3), std::min(coeff, 3)));
      }
    }
    return nnz;
  }

  // -- inter pred ------------------------------------------------------
  void parse_inter_pred(MbClass cls, int p_kind, int b_type) {
    sub_types_valid_ = false;
    struct Part { int blk, w4, h4; Pred mode; };
    Part parts[2];
    int npart;
    int blk_bottom = G.raster_to_blk4[2 * 4 + 0];
    int blk_right = G.raster_to_blk4[0 * 4 + 2];
    if (stype_ == SLICE_P || (cls == MB_INTER && b_type < 0)) {
      switch (p_kind) {
        case 0: parts[0] = {0, 4, 4, PRED_L0}; npart = 1; break;
        case 1:
          parts[0] = {0, 4, 2, PRED_L0};
          parts[1] = {blk_bottom, 4, 2, PRED_L0};
          npart = 2;
          break;
        case 2:
          parts[0] = {0, 2, 4, PRED_L0};
          parts[1] = {blk_right, 2, 4, PRED_L0};
          npart = 2;
          break;
        default: {  // P8x8
          for (int i = 0; i < 4; i++) sub_types_[i] = parse_sub_mb_type_p();
          sub_types_valid_ = true;
          parse_p8x8();
          return;
        }
      }
    } else {  // B
      const BType& bt = kBType[b_type];
      if (b_type == 22) {
        for (int i = 0; i < 4; i++) sub_types_[i] = parse_sub_mb_type_b();
        sub_types_valid_ = true;
        parse_b8x8();
        return;
      }
      if (bt.shape == 0) {
        parts[0] = {0, 4, 4, bt.m0};
        npart = 1;
      } else if (bt.shape == 1) {
        parts[0] = {0, 4, 2, bt.m0};
        parts[1] = {blk_bottom, 4, 2, bt.m1};
        npart = 2;
      } else {
        parts[0] = {0, 2, 4, bt.m0};
        parts[1] = {blk_right, 2, 4, bt.m1};
        npart = 2;
      }
    }
    for (int lst = 0; lst < 2; lst++) {
      int nref = nref_eff(lst);
      for (int i = 0; i < npart; i++) {
        Pred m = parts[i].mode;
        if (m == PRED_BI || (int)m - 1 == lst) {
          int r = nref > 1 ? parse_ref_idx(lst, parts[i].blk) : 0;
          store_ref(lst, parts[i].blk, parts[i].w4, parts[i].h4, r);
        }
      }
    }
    for (int lst = 0; lst < 2; lst++)
      for (int i = 0; i < npart; i++) {
        Pred m = parts[i].mode;
        if (m == PRED_BI || (int)m - 1 == lst)
          parse_mvd_part(lst, parts[i].blk, parts[i].w4, parts[i].h4);
      }
  }

  void parse_p8x8() {
    for (int i8 = 0; i8 < 4; i8++) {
      int blk = G.raster_to_blk4[(i8 >> 1) * 2 * 4 + (i8 & 1) * 2];
      int r = nref_eff(0) > 1 ? parse_ref_idx(0, blk) : 0;
      store_ref(0, blk, 2, 2, r);
    }
    for (int i8 = 0; i8 < 4; i8++) parse_sub_mvds(0, i8, sub_types_[i8], false);
  }

  void parse_b8x8() {
    for (int lst = 0; lst < 2; lst++) {
      int nref = nref_eff(lst);
      for (int i8 = 0; i8 < 4; i8++) {
        int t = sub_types_[i8];
        if (t == 0) continue;
        Pred m = kBSub[t].mode;
        if (m == PRED_BI || (int)m - 1 == lst) {
          int blk = G.raster_to_blk4[(i8 >> 1) * 2 * 4 + (i8 & 1) * 2];
          int r = nref > 1 ? parse_ref_idx(lst, blk) : 0;
          store_ref(lst, blk, 2, 2, r);
        }
      }
    }
    for (int lst = 0; lst < 2; lst++)
      for (int i8 = 0; i8 < 4; i8++) {
        int t = sub_types_[i8];
        if (t == 0) continue;
        Pred m = kBSub[t].mode;
        if (m == PRED_BI || (int)m - 1 == lst) parse_sub_mvds(lst, i8, t, true);
      }
  }

  void parse_sub_mvds(int lst, int i8, int subtype, bool is_b) {
    int x0 = (i8 & 1) * 2, y0 = (i8 >> 1) * 2;
    int nsp, shape;
    if (is_b) {
      nsp = kBSub[subtype].nsp;
      shape = kBSub[subtype].shape;
    } else {
      shape = subtype;
      static const int kNsp[4] = {1, 2, 2, 4};
      nsp = kNsp[shape];
    }
    for (int sp = 0; sp < nsp; sp++) {
      int bx, by, w4, h4;
      if (shape == 0) { bx = x0; by = y0; w4 = 2; h4 = 2; }
      else if (shape == 1) { bx = x0; by = y0 + sp; w4 = 2; h4 = 1; }
      else if (shape == 2) { bx = x0 + sp; by = y0; w4 = 1; h4 = 2; }
      else { bx = x0 + (sp & 1); by = y0 + (sp >> 1); w4 = 1; h4 = 1; }
      parse_mvd_part(lst, G.raster_to_blk4[by * 4 + bx], w4, h4);
    }
  }

  // I_PCM macroblock (7.3.5 / 9.3.1.2): raw samples, engines restart;
  // neighbor semantics per the spec's PCM rules
  void parse_pcm() {
    PicState* p = pic_;
    size_t m = mb(mbx_, mby_);
    int chs = ch400_ ? 0 : ch444_ ? 256 : ch422_ ? 128 : 64;
    int n = (256 * sps_.bit_depth_luma + 2 * chs * sps_.bit_depth_chroma) >> 3;
    c_->pcm_samples(n);
    for (int pl = 0; pl < 2; pl++)
      for (int i = 0; i < 16; i++) {
        p->cbf_c44[((size_t)pl * H_ * W_ + m) * 16 + i] = 1;
        p->nnz_c44[((size_t)pl * H_ * W_ + m) * 16 + i] = 16;
      }
    p->cbp_luma[m] = 15;
    p->cbp_chroma[m] = 2;
    p->t8x8[m] = 0;
    p->chroma_mode[m] = 0;
    p->cbf_luma_dc[m] = 1;
    p->cbf_chroma_dc[m * 2] = p->cbf_chroma_dc[m * 2 + 1] = 1;
    for (int i = 0; i < 16; i++) {
      p->cbf_luma[m * 16 + i] = 1;
      p->cbf_chroma_ac[m * 16 + i] = 1;
      p->nnz_luma[m * 16 + i] = 16;
      p->nnz_chroma_ac[m * 16 + i] = 15;
    }
    p->nnz_luma_dc[m] = 16;
    p->nnz_chroma_dc[m * 2] = p->nnz_chroma_dc[m * 2 + 1] =
        (uint8_t)(ch422_ ? 8 : 4);
    prev_qp_delta_nz_ = 0;
  }

  bool t8x8_allowed(MbClass cls, int p_kind, int b_type) const {
    if (cls == MB_B_DIRECT) return sps_.direct_8x8_inference_flag != 0;
    if (sub_types_valid_ && stype_ == SLICE_P) {
      for (int i = 0; i < 4; i++)
        if (sub_types_[i] != 0) return false;
      return true;
    }
    if (sub_types_valid_ && b_type == 22) {
      for (int i = 0; i < 4; i++) {
        int t = sub_types_[i];
        if (t == 0) {
          if (!sps_.direct_8x8_inference_flag) return false;
        } else if (t > 3) {
          return false;
        }
      }
      return true;
    }
    return true;
  }

  // -- residual dispatch ----------------------------------------------
  int prior_luma(int blk) const {
    int tot = 0, n = 0;
    static const int dxs[2] = {-1, 0}, dys[2] = {0, -1};
    for (int k = 0; k < 2; k++) {
      int nmbx, nmby, nblk;
      blk_nb(blk, dxs[k], dys[k], &nmbx, &nmby, &nblk);
      if (nmbx >= 0 && nmby >= 0 && nmbx < W_ && nmby < H_) {
        int32_t nsid = pic_->slice_id[mb(nmbx, nmby)];
        bool ok = isolate_ ? nsid == sid_ : nsid >= 0;
        if (ok) {
          tot += pic_->nnz_luma[mb(nmbx, nmby) * 16 + nblk];
          n++;
        }
      }
    }
    if (prev_) {
      tot += prev_->nnz_luma[mb(mbx_, mby_) * 16 + blk];
      n++;
    }
    return n ? tot / n : 0;
  }

  int prior_plane(int plane, int blk) const {
    // nnz prior over the plane's own 4x4 map (4:4:4 luma-style rows)
    const uint8_t* nnz_blk =
        plane == 0 ? pic_->nnz_luma.data()
                   : pic_->nnz_c44.data() + (size_t)(plane - 1) * H_ * W_ * 16;
    const uint8_t* prev_blk =
        !prev_ ? nullptr
               : (plane == 0
                      ? prev_->nnz_luma.data()
                      : prev_->nnz_c44.data() + (size_t)(plane - 1) * H_ * W_ * 16);
    int tot = 0, n = 0;
    static const int dxs[2] = {-1, 0}, dys[2] = {0, -1};
    for (int k = 0; k < 2; k++) {
      int nmbx, nmby, nblk;
      blk_nb(blk, dxs[k], dys[k], &nmbx, &nmby, &nblk);
      if (nmbx >= 0 && nmby >= 0 && nmbx < W_ && nmby < H_) {
        int32_t nsid = pic_->slice_id[mb(nmbx, nmby)];
        if (isolate_ ? nsid == sid_ : nsid >= 0) {
          tot += nnz_blk[mb(nmbx, nmby) * 16 + nblk];
          n++;
        }
      }
    }
    if (prev_blk) {
      tot += prev_blk[mb(mbx_, mby_) * 16 + blk];
      n++;
    }
    return n ? tot / n : 0;
  }

  // 4:4:4 (ChromaArrayType 3, 7.3.5.3): each colour plane recodes with the
  // luma block structure under its own category row and cbf/nnz maps
  void parse_plane_residuals(int plane, MbClass cls, int cbp_luma, int t8x8,
                             bool is_intra) {
    PicState* p = pic_;
    size_t m = mb(mbx_, mby_);
    int cdc = kCatDC[plane], cac = kCatAC[plane], c44 = kCat44[plane],
        c88 = kCat88[plane];
    uint8_t* cbf_blk = plane == 0
                           ? p->cbf_luma.data()
                           : p->cbf_c44.data() + (size_t)(plane - 1) * H_ * W_ * 16;
    uint8_t* nnz_blk = plane == 0
                           ? p->nnz_luma.data()
                           : p->nnz_c44.data() + (size_t)(plane - 1) * H_ * W_ * 16;
    if (cls == MB_I16) {
      int pr;
      if (plane == 0)
        pr = prev_ ? prev_->nnz_luma_dc[m] : 0;
      else
        pr = prev_ ? prev_->nnz_chroma_dc[m * 2 + plane - 1] : 0;
      int nnz = parse_residual_block(cdc, plane == 0 ? 0 : plane - 1, true,
                                     true, pr);
      if (plane == 0) {
        p->cbf_luma_dc[m] = (uint8_t)last_cbf_;
        p->nnz_luma_dc[m] = (uint8_t)nnz;
      } else {
        p->cbf_chroma_dc[m * 2 + plane - 1] = (uint8_t)last_cbf_;
        p->nnz_chroma_dc[m * 2 + plane - 1] = (uint8_t)nnz;
      }
      if (cbp_luma) {
        for (int blk = 0; blk < 16; blk++) {
          int nnz2 = parse_residual_block(cac, blk, true, true,
                                          prior_plane(plane, blk));
          cbf_blk[m * 16 + blk] = (uint8_t)last_cbf_;
          nnz_blk[m * 16 + blk] = (uint8_t)nnz2;
        }
      }
      return;
    }
    for (int i8 = 0; i8 < 4; i8++) {
      if (!((cbp_luma >> i8) & 1)) continue;
      if (t8x8) {
        int blk0 = G.raster_to_blk4[(i8 >> 1) * 8 + (i8 & 1) * 2];
        // 4:4:4 8x8 blocks DO code coded_block_flag (7.3.5.3.3)
        int nnz = parse_residual_block(c88, blk0, is_intra, true,
                                       prior_plane(plane, blk0));
        for (int j = 0; j < 4; j++) {
          int blk = i8 * 4 + j;
          cbf_blk[m * 16 + blk] = (uint8_t)last_cbf_;
          nnz_blk[m * 16 + blk] = (uint8_t)(std::min(nnz, 255) >> 2);
        }
      } else {
        for (int j = 0; j < 4; j++) {
          int blk = i8 * 4 + j;
          int nnz = parse_residual_block(c44, blk, is_intra, true,
                                         prior_plane(plane, blk));
          cbf_blk[m * 16 + blk] = (uint8_t)last_cbf_;
          nnz_blk[m * 16 + blk] = (uint8_t)nnz;
        }
      }
    }
  }

  void parse_residuals(MbClass cls, int cbp_luma, int cbp_chroma, int t8x8,
                       bool is_intra) {
    if (ch444_) {
      for (int plane = 0; plane < 3; plane++)
        parse_plane_residuals(plane, cls, cbp_luma, t8x8, is_intra);
      return;
    }
    PicState* p = pic_;
    size_t m = mb(mbx_, mby_);
    if (cls == MB_I16) {
      int pr = prev_ ? prev_->nnz_luma_dc[m] : 0;
      int nnz = parse_residual_block(CAT_LUMA_DC, 0, true, true, pr);
      p->cbf_luma_dc[m] = (uint8_t)last_cbf_;
      p->nnz_luma_dc[m] = (uint8_t)nnz;
      if (cbp_luma) {
        for (int i8 = 0; i8 < 4; i8++)
          for (int j = 0; j < 4; j++) {
            int blk = i8 * 4 + j;
            int nnz2 = parse_residual_block(CAT_LUMA_AC, blk, true, true,
                                            prior_luma(blk));
            p->cbf_luma[m * 16 + blk] = (uint8_t)last_cbf_;
            p->nnz_luma[m * 16 + blk] = (uint8_t)nnz2;
          }
      }
    } else {
      for (int i8 = 0; i8 < 4; i8++) {
        if (!((cbp_luma >> i8) & 1)) continue;
        if (t8x8) {
          int blk0 = G.raster_to_blk4[(i8 >> 1) * 8 + (i8 & 1) * 2];
          int nnz = parse_residual_block(CAT_LUMA_8x8, blk0, is_intra, false,
                                         prior_luma(blk0));
          for (int j = 0; j < 4; j++) {
            int blk = i8 * 4 + j;
            p->cbf_luma[m * 16 + blk] = 1;
            p->nnz_luma[m * 16 + blk] = (uint8_t)(std::min(nnz, 255) >> 2);
          }
        } else {
          for (int j = 0; j < 4; j++) {
            int blk = i8 * 4 + j;
            int nnz = parse_residual_block(CAT_LUMA_4x4, blk, is_intra, true,
                                           prior_luma(blk));
            p->cbf_luma[m * 16 + blk] = (uint8_t)last_cbf_;
            p->nnz_luma[m * 16 + blk] = (uint8_t)nnz;
          }
        }
      }
    }
    auto prior_chroma_dc = [&](int comp) {
      int tot = 0, n = 0;
      for (int k = 0; k < 2; k++) {
        int nx, ny;
        if (k == 0) mb_left(&nx, &ny); else mb_up(&nx, &ny);
        if (nx >= 0 && ny >= 0 && nx < W_ && ny < H_) {
          int32_t nsid = pic_->slice_id[mb(nx, ny)];
          if (isolate_ ? nsid == sid_ : nsid >= 0) {
            tot += pic_->nnz_chroma_dc[mb(nx, ny) * 2 + comp];
            n++;
          }
        }
      }
      if (prev_) {
        tot += prev_->nnz_chroma_dc[m * 2 + comp];
        n++;
      }
      return n ? tot / n : 0;
    };
    auto prior_chroma_ac = [&](int idx) {
      int comp = idx >> 3, sub = idx & 7;
      int tot = 0, n = 0;
      static const int dxs[2] = {-1, 0}, dys[2] = {0, -1};
      for (int k = 0; k < 2; k++) {
        int nmbx, nmby, nsub;
        chroma_nb(sub, dxs[k], dys[k], &nmbx, &nmby, &nsub);
        if (nmbx >= 0 && nmby >= 0 && nmbx < W_ && nmby < H_) {
          int32_t nsid = pic_->slice_id[mb(nmbx, nmby)];
          if (isolate_ ? nsid == sid_ : nsid >= 0) {
            tot += pic_->nnz_chroma_ac[mb(nmbx, nmby) * 16 + comp * 8 + nsub];
            n++;
          }
        }
      }
      if (prev_) {
        tot += prev_->nnz_chroma_ac[m * 16 + idx];
        n++;
      }
      return n ? tot / n : 0;
    };
    if (cbp_chroma) {
      for (int comp = 0; comp < 2; comp++) {
        int pr = prior_chroma_dc(comp);
        int nnz = parse_residual_block(CAT_CHROMA_DC, comp, is_intra, true, pr);
        p->cbf_chroma_dc[m * 2 + comp] = (uint8_t)last_cbf_;
        p->nnz_chroma_dc[m * 2 + comp] = (uint8_t)nnz;
      }
    }
    if (cbp_chroma == 2) {
      for (int comp = 0; comp < 2; comp++)
        for (int sub = 0; sub < n_chroma_ac_; sub++) {
          int idx = comp * 8 + sub;
          int pr = prior_chroma_ac(idx);
          int nnz = parse_residual_block(CAT_CHROMA_AC, idx, is_intra, true, pr);
          p->cbf_chroma_ac[m * 16 + idx] = (uint8_t)last_cbf_;
          p->nnz_chroma_ac[m * 16 + idx] = (uint8_t)nnz;
        }
    }
  }

  // -- macroblock ------------------------------------------------------
  // returns true when the MB was skipped
  bool parse_macroblock() {
    int skip = 0;
    if (stype_ != SLICE_I && stype_ != SLICE_SI) skip = parse_mb_skip();
    if (skip) {
      store_skip_mb();
      return true;
    }
    if (mbaff_ && !field_known_) {
      cur_field_ = eff_field_ = parse_field_flag();
      field_known_ = true;
      if (mby_ & 1)  // top MB was skipped: retro-set its stored flag
        pic_->field[mb(mbx_, mby_ - 1)] = (uint8_t)cur_field_;
    }
    parse_macroblock_layer();
    return false;
  }

  void store_skip_mb() {
    PicState* p = pic_;
    size_t m = mb(mbx_, mby_);
    p->slice_id[m] = sid_;
    p->mbclass[m] = stype_ == SLICE_P ? MB_P_SKIP : MB_B_SKIP;
    p->skip[m] = 1;
    p->field[m] = (uint8_t)cur_field_;
    for (int lst = 0; lst < 2; lst++)
      for (int q = 0; q < 4; q++)
        p->refidx[((size_t)lst * H_ * W_ + m) * 4 + q] =
            stype_ == SLICE_P ? 0 : -1;
    prev_qp_delta_nz_ = 0;
  }

  void parse_macroblock_layer() {
    PicState* p = pic_;
    size_t m = mb(mbx_, mby_);
    sub_types_valid_ = false;
    p->field[m] = (uint8_t)cur_field_;
    if (mbaff_) mbaff_neighbors();

    I16Info i16{};
    int p_kind = -1, b_type = -1;
    MbClass cls = parse_mb_type(&i16, &p_kind, &b_type);
    p->slice_id[m] = sid_;
    p->mbclass[m] = cls;
    p->skip[m] = 0;

    if (cls == MB_I_PCM) {
      parse_pcm();
      return;
    }

    int t8x8 = 0;
    bool is_intra = cls == MB_I_NXN || cls == MB_I16 || cls == MB_SI;
    int cbp_luma = 0, cbp_chroma = 0;

    if (cls == MB_SI) {
      // Intra_4x4 content; no transform_size_8x8_flag (7.3.5 gates it on
      // mb_type == I_NxN)
      parse_intra_pred_modes(16);
      if (!ch444_ && !ch400_)
        p->chroma_mode[m] = (uint8_t)parse_chroma_pred_mode();
    } else if (cls == MB_I_NXN) {
      if (pps_.transform_8x8_mode_flag) t8x8 = parse_transform_8x8();
      parse_intra_pred_modes(t8x8 ? 4 : 16);
      if (!ch444_ && !ch400_)  // 4:4:4 reuses luma modes; 4:0:0 has none
        p->chroma_mode[m] = (uint8_t)parse_chroma_pred_mode();
    } else if (cls == MB_I16) {
      cbp_chroma = i16.cbp_chroma;
      cbp_luma = i16.cbf_luma ? 15 : 0;
      if (!ch444_ && !ch400_)
        p->chroma_mode[m] = (uint8_t)parse_chroma_pred_mode();
    } else if (cls == MB_B_DIRECT) {
      // no mb_pred syntax
    } else {
      parse_inter_pred(cls, p_kind, b_type);
    }

    if (cls != MB_I16) {
      parse_cbp(&cbp_luma, &cbp_chroma, is_intra ? 1 : 0);
      if (cbp_luma && pps_.transform_8x8_mode_flag && cls != MB_I_NXN &&
          cls != MB_SI && t8x8_allowed(cls, p_kind, b_type))
        t8x8 = parse_transform_8x8();
    }
    p->cbp_luma[m] = (uint8_t)cbp_luma;
    p->cbp_chroma[m] = (uint8_t)cbp_chroma;
    p->t8x8[m] = (uint8_t)t8x8;

    if (cbp_luma || cbp_chroma || cls == MB_I16) {
      parse_mb_qp_delta();
      parse_residuals(cls, cbp_luma, cbp_chroma, t8x8, is_intra);
    } else {
      prev_qp_delta_nz_ = 0;
    }
  }

  const SPS& sps_;
  const PPS& pps_;
  const SliceHeader& hdr_;
  PicState* pic_;
  const PicState* prev_;
  Coder* c_;
  int sid_;
  bool isolate_;
  int W_, H_, stype_, nref0_, nref1_;
  int mbx_ = 0, mby_ = 0;
  // MBAFF state (mbparse.py mirrors): cur_field_ = current pair's flag
  // (decoded/predicted/provisional); eff_field_ = ffmpeg's stale-register
  // convention used for ctx derivation before the flag is decoded
  bool mbaff_ = false;
  bool field_pic_ = false;  // PAFF field picture
  int cur_field_ = 0, eff_field_ = 0;
  bool field_known_ = false;
  uint64_t field_bins_ = 0;
  int top_xy_[2] = {0, -1};
  int left_xy_[2][2] = {{-1, 0}, {-1, 0}};
  int left_ymap_[4] = {0, 1, 2, 3};
  bool ch422_ = false, ch444_ = false, ch400_ = false;
  int ch_grid_h_ = 2, n_chroma_ac_ = 4;
  int prev_qp_delta_nz_ = 0;
  int prev_qp_mag_ = 0;  // model v9 qp-delta magnitude context
  int last_cbf_ = 0;
  int sub_types_[4] = {0, 0, 0, 0};
  bool sub_types_valid_ = false;
};

}  // namespace avtpu
