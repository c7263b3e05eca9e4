// H.264 CAVLC slice-data recoding — C++ mirror of h264/cavlc.py (see that
// module's docstring for the design rationale).  The reference recodes
// only CABAC payloads (recode.cpp:149-167), so this EXCEEDS its coverage:
// baseline-profile/`--no-cabac` streams — and x264 LOSSLESS output
// (High 4:4:4 + CAVLC) — recompress instead of passing through as
// literals.
//
// Bit-level modeling: every bit the parser consumes is entropy-coded
// through the adaptive model under an element-class key; decompression
// replays the identical parse with bits from the model, so regeneration
// is identity by construction.  One bit(key) primitive differs between
// directions; the parser and all ue/se/te/VLC readers are shared.
//
// The put_bit(key, bit, 0) SEQUENCE must match h264/cavlc.py exactly —
// the Python differential suite asserts byte-identical containers.
#pragma once
#include <cstdint>
#include <unordered_map>
#include <vector>

#include "bitio.h"
#include "cavlc_tables.h"
#include "h264.h"
#include "model.h"
#include "parser.h"  // ParseError/Desync, PicState, Geom, kBType/kBSub

namespace avtpu {

// ------------------------------------------------------------ bit writer --
class BitWriter {
 public:
  void u(uint32_t value, int n) {
    for (int i = n - 1; i >= 0; i--) {
      buf_ = (buf_ << 1) | ((value >> i) & 1);
      if (++cnt_ == 8) {
        out_.push_back((uint8_t)buf_);
        buf_ = 0;
        cnt_ = 0;
      }
    }
  }
  size_t bitpos() const { return out_.size() * 8 + cnt_; }
  const Bytes& bytes() const { return out_; }

 private:
  Bytes out_;
  uint32_t buf_ = 0;
  int cnt_ = 0;
};

// ------------------------------------------------------- VLC decode maps --
// {(len << 20) | bits: symbol} tries, walked bit by bit (cavlc.py
// _decode_map mirror).  Symbols: coeff_token packs total*4+trailing.
struct CavlcMaps {
  std::unordered_map<uint32_t, int32_t> ct[6];
  std::unordered_map<uint32_t, int32_t> tz[15], tz22[3], tz24[7], rb[7];

  static uint32_t k(int len, uint32_t bits) {
    return ((uint32_t)len << 20) | bits;
  }
  CavlcMaps() {
    for (int t = 0; t < 6; t++) {
      int n_tot = t == 4 ? 4 : t == 5 ? 8 : 16;
      for (int total = 0; total <= n_tot; total++)
        for (int to = 0; to <= (total == 0 ? 0 : std::min(3, total)); to++) {
          VlcCode c = kCoeffToken[t][total][to];
          if (c.size) ct[t][k(c.size, c.bits)] = total * 4 + to;
        }
    }
    for (int tc = 1; tc <= 15; tc++)
      for (int z = 0; z <= 16 - tc; z++) {
        VlcCode c = kTotalZeros[tc - 1][z];
        if (c.size) tz[tc - 1][k(c.size, c.bits)] = z;
      }
    for (int tc = 1; tc <= 3; tc++)
      for (int z = 0; z <= 4 - tc; z++) {
        VlcCode c = kTotalZeros2x2[tc - 1][z];
        if (c.size) tz22[tc - 1][k(c.size, c.bits)] = z;
      }
    for (int tc = 1; tc <= 7; tc++)
      for (int z = 0; z <= 8 - tc; z++) {
        VlcCode c = kTotalZeros2x4[tc - 1][z];
        if (c.size) tz24[tc - 1][k(c.size, c.bits)] = z;
      }
    for (int zl = 1; zl <= 7; zl++)
      for (int run = 0; run <= (zl < 7 ? zl : 14); run++) {
        VlcCode c = kRunBefore[zl - 1][run];
        if (c.size) rb[zl - 1][k(c.size, c.bits)] = run;
      }
  }
};
inline const CavlcMaps kCavlcMaps{};

constexpr int kVlcMax = 20;  // longest code is 16 bits; margin for desync

// ------------------------------------------------------------ the coder --
struct CavlcCoder {
  bool is_compress;
  RecodeModel* model = nullptr;
  uint64_t n_bins = 0;
  // compress side
  const uint8_t* rbsp = nullptr;
  size_t rbsp_size = 0;
  BitReader r{nullptr, 0};
  int64_t stop_bitpos = -1;
  // decompress side
  BitWriter w;

  void init_compress(const uint8_t* p, size_t n, size_t start_bit,
                     RecodeModel* m) {
    is_compress = true;
    rbsp = p;
    rbsp_size = n;
    r = BitReader(p, n, start_bit);
    model = m;
    stop_bitpos = -1;
    for (size_t i = n; i-- > 0;) {
      if (p[i]) {
        uint8_t b = p[i];
        stop_bitpos = (int64_t)i * 8 + 7;
        while (!(b & 1)) {
          b >>= 1;
          stop_bitpos--;
        }
        break;
      }
    }
  }
  void init_decompress(RecodeModel* m, uint32_t seed_val, int seed_bits) {
    is_compress = false;
    model = m;
    if (seed_bits) w.u(seed_val, seed_bits);
  }

  int bit(uint64_t key) {
    n_bins++;
    if (is_compress) {
      int b = (int)r.u(1);
      if (model) model->put_bit(key, b, 0);
      return b;
    }
    int b = model->get_bit(key, 0);
    w.u((uint32_t)b, 1);
    return b;
  }

  bool more_data(int done, int mb_count) const {
    if (is_compress) return (int64_t)r.bitpos() < stop_bitpos;
    return done < mb_count;
  }

  // compress: verify canonical rbsp_slice_trailing_bits, return extra tail
  Bytes finish_compress() {
    if (r.u(1) != 1) throw Desync("missing rbsp stop bit");
    while (r.bitpos() & 7)
      if (r.u(1) != 0) throw Desync("nonzero rbsp padding bit");
    return Bytes(rbsp + (r.bitpos() >> 3), rbsp + rbsp_size);
  }
  const Bytes& finish_decompress() {
    w.u(1, 1);  // rbsp_stop_one_bit
    while (w.bitpos() & 7) w.u(0, 1);
    return w.bytes();
  }
};

// ----------------------------------------------------------- the parser --
class CavlcSliceParser {
 public:
  CavlcSliceParser(const SPS& sps, const PPS& pps, const SliceHeader& hdr,
                   PicState* pic, CavlcCoder* c, int sid)
      : sps_(sps), pps_(pps), hdr_(hdr), pic_(pic), c_(c), sid_(sid),
        W_(sps.pic_width_in_mbs),
        H_(sps.pic_height_in_map_units * (sps.frame_mbs_only_flag ? 1 : 2)) {
    if (hdr.mbaff || hdr.field_pic) throw Unsupported("CAVLC interlace");
    if (hdr.slice_type != SLICE_I && hdr.slice_type != SLICE_P &&
        hdr.slice_type != SLICE_B)
      throw Unsupported("CAVLC SP/SI slice");
    stype_ = hdr.slice_type;
    ch422_ = sps.chroma_format_idc == 2;
    // 4:4:4 (non-separate): Cb/Cr parse as luma-style planes sharing the
    // luma cbp bits (7.3.5.3 ChromaArrayType==3); separate colour planes
    // parse as monochrome pictures (ch400)
    ch444_ = sps.chroma_format_idc == 3 && !sps.separate_colour_plane_flag;
    ch400_ = sps.chroma_format_idc == 0 || sps.separate_colour_plane_flag;
    ch_grid_h_ = ch422_ ? 4 : 2;
    n_chroma_ac_ = ch422_ ? 8 : 4;
    nref0_ = hdr.num_ref_idx_l0_active;
    nref1_ = hdr.num_ref_idx_l1_active;
  }

  int parse_slice_data(int mb_count) {
    CavlcCoder* c = c_;
    int total_mbs = W_ * H_;
    int addr = hdr_.first_mb_in_slice;
    int done = 0;
    for (;;) {
      if (stype_ != SLICE_I) {
        int run = (int)ue(K_VSKIP, 0);
        if (addr + run > total_mbs) throw Desync("skip run past picture");
        for (int i = 0; i < run; i++) {
          mark_skip(addr);
          addr++;
          done++;
        }
        if (run > 0 && !c->more_data(done, mb_count)) break;
      }
      if (addr >= total_mbs) throw Desync("mb address past picture");
      mbx_ = addr % W_;
      mby_ = addr / W_;
      parse_macroblock_layer();
      addr++;
      done++;
      if (!c->more_data(done, mb_count)) break;
    }
    return done;
  }

 private:
  // -- primitives ------------------------------------------------------
  uint32_t ue(uint32_t cls, uint32_t a, int cap = 31) {
    int zeros = 0;
    while (c_->bit(mkey(cls, a, 0, std::min(zeros, 15))) == 0) {
      zeros++;
      if (zeros > cap) throw Desync("ue overrun");
    }
    uint32_t v = 0;
    for (int i = 0; i < zeros; i++)
      v = (v << 1) | c_->bit(mkey(cls, a, 1, std::min(i, 15)));
    return (uint32_t)((1u << zeros) - 1 + v);
  }
  int32_t se(uint32_t cls, uint32_t a) {
    uint32_t k = ue(cls, a);
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
  }
  uint32_t te(uint32_t cls, uint32_t a, int cmax) {
    if (cmax == 0) return 0;
    if (cmax == 1) return 1 - c_->bit(mkey(cls, a, 0, 0));
    uint32_t v = ue(cls, a);
    if ((int)v > cmax) throw Desync("te out of range");
    return v;
  }
  int32_t vlc(const std::unordered_map<uint32_t, int32_t>& m, uint32_t cls,
              uint32_t a) {
    uint32_t val = 0;
    for (int ln = 1; ln <= kVlcMax; ln++) {
      val = (val << 1) | c_->bit(mkey(cls, a, std::min(ln - 1, 15)));
      auto it = m.find(CavlcMaps::k(ln, val));
      if (it != m.end()) return it->second;
    }
    throw Desync("vlc overrun");
  }

  // -- availability / nC (9.2.1) ---------------------------------------
  size_t mb(int x, int y) const { return (size_t)y * W_ + x; }
  bool avail(int x, int y) const {
    if (x < 0 || y < 0 || x >= W_ || y >= H_) return false;
    return pic_->slice_id[mb(x, y)] == sid_;
  }
  static void blk4_nb(int mbx, int mby, int blk, int dx, int dy, int* nx,
                      int* ny, int* nblk) {
    int x = G.blk4_x[blk] + dx, y = G.blk4_y[blk] + dy;
    *nx = mbx;
    *ny = mby;
    if (x < 0) { (*nx)--; x += 4; } else if (x > 3) { (*nx)++; x -= 4; }
    if (y < 0) { (*ny)--; y += 4; } else if (y > 3) { (*ny)++; y -= 4; }
    *nblk = G.raster_to_blk4[y * 4 + x];
  }
  void chroma_nb(int blk, int dx, int dy, int* nx, int* ny, int* nblk) const {
    int gh = ch_grid_h_;
    int x = (blk & 1) + dx, y = (blk >> 1) + dy;
    *nx = mbx_;
    *ny = mby_;
    if (x < 0) { (*nx)--; x += 2; } else if (x > 1) { (*nx)++; x -= 2; }
    if (y < 0) { (*ny)--; y += gh; } else if (y > gh - 1) { (*ny)++; y -= gh; }
    *nblk = y * 2 + x;
  }
  int nc_luma(int blk, int plane = 0) const {
    const uint8_t* nmap =
        plane == 0 ? pic_->nnz_luma.data()
                   : pic_->nnz_c44.data() +
                         (size_t)(plane - 1) * pic_->w * pic_->h * 16;
    int lx, ly, lb, ux, uy, ub;
    blk4_nb(mbx_, mby_, blk, -1, 0, &lx, &ly, &lb);
    blk4_nb(mbx_, mby_, blk, 0, -1, &ux, &uy, &ub);
    bool la = avail(lx, ly), ua = avail(ux, uy);
    int na = la ? nmap[mb(lx, ly) * 16 + lb] : 0;
    int nb = ua ? nmap[mb(ux, uy) * 16 + ub] : 0;
    if (la && ua) return (na + nb + 1) >> 1;
    return la ? na : (ua ? nb : 0);
  }
  int nc_chroma(int comp, int sub) const {
    int lx, ly, lb, ux, uy, ub;
    chroma_nb(sub, -1, 0, &lx, &ly, &lb);
    chroma_nb(sub, 0, -1, &ux, &uy, &ub);
    bool la = avail(lx, ly), ua = avail(ux, uy);
    int na = la ? pic_->nnz_chroma_ac[mb(lx, ly) * 16 + comp * 8 + lb] : 0;
    int nb = ua ? pic_->nnz_chroma_ac[mb(ux, uy) * 16 + comp * 8 + ub] : 0;
    if (la && ua) return (na + nb + 1) >> 1;
    return la ? na : (ua ? nb : 0);
  }

  // -- residual block (9.2) --------------------------------------------
  int residual_block(int nc, int max_coeff, int cat) {
    int tab = nc >= 8 ? 3
              : nc >= 4 ? 2
              : nc >= 2 ? 1
              : nc >= 0 ? 0
              : nc == -1 ? 4
                         : 5;
    int sym = vlc(kCavlcMaps.ct[tab], K_VTOK, tab);
    int total = sym >> 2, trailing = sym & 3;
    if (total > max_coeff) throw Desync("coeff_token exceeds block");
    for (int i = 0; i < trailing; i++) c_->bit(mkey(K_VT1, i));
    int sl = (total > 10 && trailing < 3) ? 1 : 0;
    for (int i = 0; i < total - trailing; i++) {
      int prefix = 0;
      while (c_->bit(mkey(K_VLP, std::min(prefix, 15), sl, cat)) == 0) {
        prefix++;
        if (prefix > 31) throw Desync("level_prefix overrun");
      }
      int suffix_size = sl;
      if (prefix == 14 && sl == 0)
        suffix_size = 4;
      else if (prefix >= 15)
        suffix_size = prefix - 3;
      uint32_t suffix = 0;
      for (int j = 0; j < suffix_size; j++)
        suffix = (suffix << 1) |
                 c_->bit(mkey(K_VLS, std::min(j, 13), sl, cat));
      uint32_t level_code = ((uint32_t)std::min(15, prefix) << sl) + suffix;
      if (prefix >= 15 && sl == 0) level_code += 15;
      if (prefix >= 16) level_code += (1u << (prefix - 3)) - 4096;
      if (i == 0 && trailing < 3) level_code += 2;
      uint32_t abs_level = (level_code >> 1) + 1;
      if (sl == 0) sl = 1;
      if (abs_level > (3u << (sl - 1)) && sl < 6) sl++;
    }
    int zeros = 0;
    if (total && total < max_coeff) {
      if (max_coeff == 4)
        zeros = vlc(kCavlcMaps.tz22[total - 1], K_VTZ, 16 + total);
      else if (max_coeff == 8)
        zeros = vlc(kCavlcMaps.tz24[total - 1], K_VTZ, 20 + total);
      else
        zeros = vlc(kCavlcMaps.tz[total - 1], K_VTZ, total);
      if (zeros > max_coeff - total) throw Desync("total_zeros exceeds block");
    }
    int zl = zeros;
    for (int i = 0; i < total - 1 && zl > 0; i++) {
      int run = vlc(kCavlcMaps.rb[std::min(zl, 7) - 1], K_VRUN,
                    std::min(zl, 7) + 8 * std::min(i, 3));
      if (run > zl) throw Desync("run_before exceeds zerosLeft");
      zl -= run;
    }
    return total;
  }

  // -- macroblock layer (7.3.5) ----------------------------------------
  int t8_inc() const {
    int inc = 0;
    if (avail(mbx_ - 1, mby_)) inc += pic_->t8x8[mb(mbx_ - 1, mby_)];
    if (avail(mbx_, mby_ - 1)) inc += pic_->t8x8[mb(mbx_, mby_ - 1)];
    return inc;
  }
  void intra_pred_modes(int n_blocks) {
    for (int i = 0; i < n_blocks; i++) {
      if (!c_->bit(mkey(K_VIPRED, 0)))
        for (int j = 0; j < 3; j++) c_->bit(mkey(K_VIPRED, 1 + j));
    }
    if (!ch400_ && !ch444_) {
      uint32_t v = ue(K_VCPRED, 0, 7);
      if (v > 3) throw Desync("chroma pred mode");
    }
  }
  void mvd1(int comp) {
    // keyed on the previous |mvd|'s magnitude bucket (shared across
    // components/MBs within the slice — cavlc.py mirror, A/B +0.11%)
    int32_t v = se(K_VMVD, comp + 2 * mvd_b_);
    uint32_t a = v >= 0 ? v : -v;
    mvd_b_ = a == 0 ? 0 : a < 4 ? 1 : a < 32 ? 2 : 3;
  }
  void mvd() {
    mvd1(0);
    mvd1(1);
  }
  void parse_pcm() {
    CavlcCoder* c = c_;
    if (c->is_compress) {
      while (c->r.bitpos() & 7)
        if (c->r.u(1) != 0) throw Desync("nonzero pcm alignment bit");
    } else {
      while (c->w.bitpos() & 7) c->w.u(0, 1);
    }
    int bd_y = sps_.bit_depth_luma, bd_c = sps_.bit_depth_chroma;
    int n_chroma = ch400_ ? 0 : ch444_ ? 512 : ch422_ ? 256 : 128;
    int n_bytes = (256 * bd_y + n_chroma * bd_c) >> 3;
    for (int k = 0; k < n_bytes; k++)
      for (int i = 0; i < 8; i++) c->bit(mkey(K_PCM, i));
    size_t m = mb(mbx_, mby_);
    for (int i = 0; i < 16; i++) {
      pic_->nnz_luma[m * 16 + i] = 16;
      pic_->nnz_chroma_ac[m * 16 + i] = 16;
    }
    {
      size_t pn = (size_t)pic_->w * pic_->h * 16;
      for (int pl = 0; pl < 2; pl++)
        for (int i = 0; i < 16; i++)
          pic_->nnz_c44[pl * pn + m * 16 + i] = 16;
    }
    pic_->t8x8[m] = 0;
    pic_->mbclass[m] = 7;  // I_PCM: intra for neighbor ctx
  }

  bool t8_allowed(int raw) const {
    if (stype_ == SLICE_P) {
      if (raw == 3 || raw == 4) {
        for (int i = 0; i < 4; i++)
          if (sub_types_[i] != 0) return false;
        return true;
      }
      return true;
    }
    if (raw == 0) return sps_.direct_8x8_inference_flag != 0;
    if (raw == 22) {
      for (int i = 0; i < 4; i++) {
        const BSub& s = kBSub[sub_types_[i]];
        if (s.mode == PRED_DIRECT) {
          if (!sps_.direct_8x8_inference_flag) return false;
        } else if (s.shape != 0) {
          return false;
        }
      }
      return true;
    }
    return true;
  }

  void p_inter(int raw) {
    if (raw > 4) throw Desync("P mb_type out of range");
    int nref = nref0_;
    if (raw == 0) {
      if (nref > 1) te(K_VREF, 0, nref - 1);
      mvd();
    } else if (raw == 1 || raw == 2) {
      for (int p = 0; p < 2; p++)
        if (nref > 1) te(K_VREF, 0, nref - 1);
      for (int p = 0; p < 2; p++) mvd();
    } else {
      for (int i = 0; i < 4; i++) {
        uint32_t s = ue(K_VSUB, 0, 15);
        if (s > 3) throw Desync("P sub_mb_type out of range");
        sub_types_[i] = (int)s;
      }
      if (raw == 3 && nref > 1)
        for (int i = 0; i < 4; i++) te(K_VREF, 0, nref - 1);
      static const int nparts[4] = {1, 2, 2, 4};
      for (int i = 0; i < 4; i++)
        for (int p = 0; p < nparts[sub_types_[i]]; p++) mvd();
    }
  }

  void b_inter(int raw) {
    if (raw > 22) throw Desync("B mb_type out of range");
    if (raw == 0) return;  // B_Direct_16x16
    if (raw == 22) {
      for (int i = 0; i < 4; i++) {
        uint32_t s = ue(K_VSUB, 1, 15);
        if (s > 12) throw Desync("B sub_mb_type out of range");
        sub_types_[i] = (int)s;
      }
      for (int lst = 0; lst < 2; lst++) {
        int nref = lst == 0 ? nref0_ : nref1_;
        if (nref <= 1) continue;
        Pred use = lst == 0 ? PRED_L0 : PRED_L1;
        for (int i = 0; i < 4; i++) {
          Pred p = kBSub[sub_types_[i]].mode;
          if (p == use || p == PRED_BI) te(K_VREF, lst, nref - 1);
        }
      }
      for (int lst = 0; lst < 2; lst++) {
        Pred use = lst == 0 ? PRED_L0 : PRED_L1;
        for (int i = 0; i < 4; i++) {
          const BSub& s = kBSub[sub_types_[i]];
          if (s.mode == use || s.mode == PRED_BI)
            for (int p = 0; p < s.nsp; p++) mvd();
        }
      }
      return;
    }
    const BType& info = kBType[raw];
    for (int lst = 0; lst < 2; lst++) {
      int nref = lst == 0 ? nref0_ : nref1_;
      if (nref <= 1) continue;
      Pred use = lst == 0 ? PRED_L0 : PRED_L1;
      for (int p = 0; p < info.npart; p++) {
        Pred m = p == 0 ? info.m0 : info.m1;
        if (m == use || m == PRED_BI) te(K_VREF, lst, nref - 1);
      }
    }
    for (int lst = 0; lst < 2; lst++) {
      Pred use = lst == 0 ? PRED_L0 : PRED_L1;
      for (int p = 0; p < info.npart; p++) {
        Pred m = p == 0 ? info.m0 : info.m1;
        if (m == use || m == PRED_BI) mvd();
      }
    }
  }

  void residuals(bool i16, int cbp_luma, int cbp_chroma) {
    size_t m = mb(mbx_, mby_);
    if (ch444_) {
      // ChromaArrayType 3: three luma-style planes share cbp_luma
      for (int plane = 0; plane < 3; plane++) {
        uint8_t* nmap =
            plane == 0 ? pic_->nnz_luma.data()
                       : pic_->nnz_c44.data() +
                             (size_t)(plane - 1) * pic_->w * pic_->h * 16;
        if (i16) residual_block(nc_luma(0, plane), 16, 2);
        for (int i8 = 0; i8 < 4; i8++) {
          if (!(cbp_luma & (1 << i8))) continue;
          for (int i4 = 0; i4 < 4; i4++) {
            int blk = i8 * 4 + i4;
            int total = residual_block(nc_luma(blk, plane),
                                       i16 ? 15 : 16, 0);
            nmap[m * 16 + blk] = (uint8_t)total;
          }
        }
      }
      return;
    }
    if (i16) residual_block(nc_luma(0), 16, 2);
    for (int i8 = 0; i8 < 4; i8++) {
      if (!(cbp_luma & (1 << i8))) continue;
      for (int i4 = 0; i4 < 4; i4++) {
        int blk = i8 * 4 + i4;
        int total = residual_block(nc_luma(blk), i16 ? 15 : 16, 0);
        pic_->nnz_luma[m * 16 + blk] = (uint8_t)total;
      }
    }
    if (ch400_) return;
    if (cbp_chroma & 3) {
      int nc_dc = ch422_ ? -2 : -1;
      int n_dc = ch422_ ? 8 : 4;
      for (int comp = 0; comp < 2; comp++) residual_block(nc_dc, n_dc, 2);
    }
    if (cbp_chroma & 2) {
      for (int comp = 0; comp < 2; comp++)
        for (int sub = 0; sub < n_chroma_ac_; sub++) {
          int total = residual_block(nc_chroma(comp, sub), 15, 1);
          pic_->nnz_chroma_ac[m * 16 + comp * 8 + sub] = (uint8_t)total;
        }
    }
  }

  void mark_skip(int addr) {
    int x = addr % W_, y = addr / W_;
    size_t m = mb(x, y);
    pic_->slice_id[m] = sid_;
    pic_->skip[m] = 1;
    pic_->mbclass[m] = 1;
    for (int i = 0; i < 16; i++) {
      pic_->nnz_luma[m * 16 + i] = 0;
      pic_->nnz_chroma_ac[m * 16 + i] = 0;
    }
    if (ch444_) {
      size_t pn = (size_t)pic_->w * pic_->h * 16;
      for (int pl = 0; pl < 2; pl++)
        for (int i = 0; i < 16; i++) pic_->nnz_c44[pl * pn + m * 16 + i] = 0;
    }
    pic_->t8x8[m] = 0;
  }

  void parse_macroblock_layer() {
    size_t m = mb(mbx_, mby_);
    pic_->slice_id[m] = sid_;
    pic_->skip[m] = 0;
    for (int i = 0; i < 16; i++) {
      pic_->nnz_luma[m * 16 + i] = 0;
      pic_->nnz_chroma_ac[m * 16 + i] = 0;
    }
    if (ch444_) {
      size_t pn = (size_t)pic_->w * pic_->h * 16;
      for (int pl = 0; pl < 2; pl++)
        for (int i = 0; i < 16; i++) pic_->nnz_c44[pl * pn + m * 16 + i] = 0;
    }
    pic_->t8x8[m] = 0;
    int st = stype_;
    uint32_t mbt_a = st == SLICE_I ? 0 : (st == SLICE_P ? 1 : 2);
    int minc = 0;  // neighbor intra-ness: mb_type clusters spatially
    if (avail(mbx_ - 1, mby_) && pic_->mbclass[mb(mbx_ - 1, mby_)] >= 5)
      minc++;
    if (avail(mbx_, mby_ - 1) && pic_->mbclass[mb(mbx_, mby_ - 1)] >= 5)
      minc++;
    uint32_t raw = ue(K_VMBT, mbt_a + 3 * minc, 63);
    int intra_base = -1;
    if (st == SLICE_I)
      intra_base = (int)raw;
    else if (st == SLICE_P && raw >= 5)
      intra_base = (int)raw - 5;
    else if (st == SLICE_B && raw >= 23)
      intra_base = (int)raw - 23;

    bool i16 = false;
    int cbp_luma = 0, cbp_chroma = 0, t8 = 0;
    bool is_intra = intra_base >= 0;
    if (is_intra) {
      if (intra_base > 25) throw Desync("mb_type out of range");
      if (intra_base == 25) {  // I_PCM
        parse_pcm();
        return;
      }
      if (intra_base == 0) {  // I_NxN
        if (pps_.transform_8x8_mode_flag)
          t8 = c_->bit(mkey(K_VT8, t8_inc()));
        intra_pred_modes(t8 ? 4 : 16);
      } else {  // I_16x16
        i16 = true;
        int b = intra_base - 1;
        cbp_luma = b >= 12 ? 15 : 0;
        cbp_chroma = (b >> 2) % 3;
        if (!ch400_ && !ch444_) {
          uint32_t v = ue(K_VCPRED, 0, 7);
          if (v > 3) throw Desync("chroma pred mode");
        }
      }
    } else if (st == SLICE_P) {
      p_inter((int)raw);
    } else {
      b_inter((int)raw);
    }

    if (!i16) {
      uint32_t cn = ue(K_VCBP, is_intra ? 1 : 0, 63);
      int cbp;
      if (ch400_ || ch444_) {  // ChromaArrayType 0/3: Table 9-4
        if (cn >= 16) throw Desync("cbp codeNum out of range");
        cbp = is_intra ? kCbpIntraMono[cn] : kCbpInterMono[cn];
      } else {
        if (cn >= 48) throw Desync("cbp codeNum out of range");
        cbp = is_intra ? kCbpIntra[cn] : kCbpInter[cn];
      }
      cbp_luma = cbp & 15;
      cbp_chroma = cbp >> 4;
      if (cbp_luma && pps_.transform_8x8_mode_flag && !is_intra &&
          t8_allowed((int)raw))
        t8 = c_->bit(mkey(K_VT8, t8_inc()));
    }
    pic_->mbclass[m] = is_intra ? 5 : 4;
    pic_->t8x8[m] = (uint8_t)t8;

    if (cbp_luma || cbp_chroma || i16) {
      se(K_VDQP, 0);
      residuals(i16, cbp_luma, cbp_chroma);
    }
  }

  const SPS& sps_;
  const PPS& pps_;
  const SliceHeader& hdr_;
  PicState* pic_;
  CavlcCoder* c_;
  int sid_;
  int W_, H_;
  int stype_ = 0;
  bool ch422_ = false, ch400_ = false, ch444_ = false;
  int ch_grid_h_ = 2, n_chroma_ac_ = 4;
  int nref0_ = 1, nref1_ = 1;
  int mbx_ = 0, mby_ = 0;
  int mvd_b_ = 0;
  int sub_types_[4] = {0, 0, 0, 0};
};

}  // namespace avtpu
