// H.264 CABAC arithmetic engine — C++ mirror of ops/cabac.py (spec 9.3).
#pragma once
#include <cstdint>
#include <algorithm>
#include "bitio.h"
#include "tables.h"

namespace avtpu {

constexpr int kNumCtx = 1024;
constexpr int kCtxTerminate = 276;

// Packed context state: (pStateIdx << 1) | valMPS, per ctxIdx.
struct CtxStates {
  uint8_t s[kNumCtx];

  // clause 9.3.1.1; cabac_init_idc < 0 selects the I-slice table
  void init(int slice_qp, int cabac_init_idc) {
    const int8_t* tab =
        cabac_init_idc < 0 ? kCtxInitI : kCtxInitPB + 2048 * cabac_init_idc;
    int qp = std::clamp(slice_qp, 0, 51);
    for (int i = 0; i < kNumCtx; i++) {
      int m = tab[2 * i], n = tab[2 * i + 1];
      int pre = std::clamp(((m * qp) >> 4) + n, 1, 126);
      int mps = pre > 63;
      int pstate = pre <= 63 ? 63 - pre : pre - 64;
      s[i] = (uint8_t)((pstate << 1) | mps);
    }
  }
};

class CabacDecoder {
 public:
  CabacDecoder(const uint8_t* data, size_t size) : data_(data), size_(size) {
    range_ = 510;
    offset_ = 0;
    for (int i = 0; i < 9; i++) offset_ = (offset_ << 1) | bit();
  }

  int decision(CtxStates& st, int ctx) {
    uint8_t s = st.s[ctx];
    int pstate = s >> 1, mps = s & 1;
    int r_lps = kRangeTabLPS[4 * pstate + ((range_ >> 6) & 3)];
    range_ -= r_lps;
    int bin;
    if (offset_ >= range_) {
      bin = mps ^ 1;
      offset_ -= range_;
      range_ = r_lps;
      if (pstate == 0) mps ^= 1;
      st.s[ctx] = (uint8_t)((kTransIdxLPS[pstate] << 1) | mps);
    } else {
      bin = mps;
      st.s[ctx] = (uint8_t)((kTransIdxMPS[pstate] << 1) | mps);
    }
    while (range_ < 256) {
      range_ <<= 1;
      offset_ = (offset_ << 1) | bit();
    }
    return bin;
  }

  int bypass() {
    offset_ = (offset_ << 1) | bit();
    if (offset_ >= range_) {
      offset_ -= range_;
      return 1;
    }
    return 0;
  }

  int terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    while (range_ < 256) {
      range_ <<= 1;
      offset_ = (offset_ << 1) | bit();
    }
    return 0;
  }

  size_t bitpos() const { return bitpos_; }

 private:
  int bit() {
    size_t byte_i = bitpos_ >> 3;
    int b = byte_i < size_ ? (data_[byte_i] >> (7 - (bitpos_ & 7))) & 1 : 0;
    bitpos_++;
    return b;
  }
  const uint8_t* data_;
  size_t size_;
  size_t bitpos_ = 0;
  uint32_t range_, offset_;
};

// Byte-queue encoder core: `low` carries the 10-bit active window at bits
// [0,10) and every renormalization shift stacks the departing bit above it;
// whole BYTES are popped off the stack with carry deferral (0xFF bytes are
// escrowed in a run counter until a non-0xFF byte fences them), replacing
// the spec's bit-at-a-time PutBit/outstanding loop.  The spec's dropped
// first bit rides the FIRST pop's carry into a dummy leading byte (queue
// starts at -9: the first pop extracts 9 bits).  Output is byte-identical
// to the bit-loop formulation (differential-tested on random streams and
// on every corpus slice via verify_tail).
struct CabacByteQueue {
  uint64_t low_ = 0;
  int queue_ = -9;
  uint64_t ffrun_ = 0;
  Bytes out_{0};  // dummy byte: absorbs the dropped-first-bit carry

  inline void shift(int n) {
    low_ <<= n;
    queue_ += n;
    if (queue_ >= 0) pop();
  }
  void pop() {
    do {
      unsigned out = (unsigned)(low_ >> (queue_ + 10));
      low_ &= (((uint64_t)0x400 << queue_) - 1);
      queue_ -= 8;
      if ((out & 0xFF) == 0xFF) {
        ffrun_++;
      } else {
        unsigned carry = out >> 8;
        out_.back() = (uint8_t)(out_.back() + carry);
        for (; ffrun_; ffrun_--) out_.push_back((uint8_t)(0xFF + carry));
        out_.push_back((uint8_t)(out & 0xFF));
      }
    } while (queue_ >= 0);
  }
  // final-flush tail: 3 finale bits were already shifted in by the caller;
  // pad with zero bits to the byte boundary (effective pending data bits =
  // queue+8: the first pop consumes 9), resolve the 0xFF escrow, drop the
  // dummy byte
  void finish() {
    int ep = queue_ + 8;
    low_ &= ~(uint64_t)0x3FF;
    int pad = (8 - (ep & 7)) & 7;
    if (pad) shift(pad);
    for (; ffrun_; ffrun_--) out_.push_back(0xFF);
    out_.erase(out_.begin() + dummy_pos_);
  }
  // restart mid-stream after I_PCM samples (9.3.1.2): fresh registers, new
  // dropped-first-bit dummy byte at the current tail
  void reinit() {
    low_ = 0;
    queue_ = -9;
    ffrun_ = 0;
    dummy_pos_ = (long)out_.size();
    out_.push_back(0);
  }
  long dummy_pos_ = 0;
};

class CabacEncoder {
 public:
  void decision(CtxStates& st, int ctx, int bin) {
    uint8_t s = st.s[ctx];
    int pstate = s >> 1, mps = s & 1;
    uint32_t r_lps = kRangeTabLPS[4 * pstate + ((range_ >> 6) & 3)];
    range_ -= r_lps;
    if (bin != mps) {
      q_.low_ += range_;
      range_ = r_lps;
      if (pstate == 0) mps ^= 1;
      st.s[ctx] = (uint8_t)((kTransIdxLPS[pstate] << 1) | mps);
    } else {
      st.s[ctx] = (uint8_t)((kTransIdxMPS[pstate] << 1) | mps);
    }
    if (range_ < 256) {
      int n = __builtin_clz(range_) - 23;
      q_.shift(n);
      range_ <<= n;
    }
  }

  void bypass(int bin) {
    q_.low_ <<= 1;
    q_.queue_ += 1;
    if (bin) q_.low_ += range_;
    if (q_.queue_ >= 0) q_.pop();
  }

  void terminate(int bin) {
    range_ -= 2;
    if (bin) {
      q_.low_ += range_;
      flush();
    } else if (range_ < 256) {
      int n = __builtin_clz(range_) - 23;
      q_.shift(n);
      range_ <<= n;
    }
  }

  const Bytes& bytes() const { return q_.out_; }
  size_t size() const { return q_.out_.size(); }

  // I_PCM: raw samples at the byte boundary after the flushed terminate,
  // then the arithmetic engine restarts (context states persist)
  void pcm_bytes(const uint8_t* p, size_t n) {
    q_.out_.insert(q_.out_.end(), p, p + n);
    range_ = 510;
    q_.reinit();
  }

 private:
  void flush() {
    q_.shift(7);                 // range 2 -> 256 renorm
    q_.shift(1);                 // (low >> 9) & 1
    q_.shift(1);                 // (low >> 8) & 1
    q_.low_ |= (uint64_t)1 << 9; // stop bit
    q_.shift(1);
    q_.finish();
  }

  CabacByteQueue q_;
  uint32_t range_ = 510;
};

// Fused CABAC decode + bit-exact re-encode (the compress-side "verify"
// pass).  The verify encoder's context states and range register follow the
// decoder's exactly (same r_lps, same MPS/LPS branch, same renorm shifts),
// so a fused engine does ONE state lookup/update and ONE renorm loop per
// bin where Coder previously ran CabacDecoder + CabacEncoder side by side
// (~2x the table walks).  Output is byte-identical to CabacEncoder fed the
// decoded bins — guarded by the Python/C++ differential suite.
class CabacXcoder {
 public:
  CabacXcoder(const uint8_t* data, size_t size) : data_(data), size_(size) {
    range_ = 510;
    offset_ = take(9);
  }

  int decision(CtxStates& st, int ctx) {
    // branchless LPS/MPS select: the compare outcome is data-dependent and
    // mispredicts dominate the branching formulation on mixed content
    uint8_t s = st.s[ctx];
    int pstate = s >> 1, mps = s & 1;
    uint32_t r_lps = kRangeTabLPS[4 * pstate + ((range_ >> 6) & 3)];
    range_ -= r_lps;
    int is_lps = offset_ >= range_;
    uint8_t ns_mps = (uint8_t)((kTransIdxMPS[pstate] << 1) | mps);
    uint8_t ns_lps =
        (uint8_t)((kTransIdxLPS[pstate] << 1) | (mps ^ (pstate == 0)));
    int bin = mps ^ is_lps;
    q_.low_ += is_lps ? range_ : 0;  // encoder LPS path: post-sub range
    offset_ -= is_lps ? range_ : 0;
    range_ = is_lps ? r_lps : range_;
    st.s[ctx] = is_lps ? ns_lps : ns_mps;
    if (range_ < 256) {
      int n = __builtin_clz(range_) - 23;
      offset_ = (offset_ << n) | take(n);
      range_ <<= n;
      q_.shift(n);
    }
    return bin;
  }

  int bypass() {
    offset_ = (offset_ << 1) | take(1);
    int b = 0;
    if (offset_ >= range_) {
      offset_ -= range_;
      b = 1;
    }
    q_.low_ <<= 1;
    q_.queue_ += 1;
    if (b) q_.low_ += range_;
    if (q_.queue_ >= 0) q_.pop();
    return b;
  }

  int terminate() {
    range_ -= 2;
    if (offset_ >= range_) {
      q_.low_ += range_;
      flush();
      return 1;
    }
    if (range_ < 256) {
      int n = __builtin_clz(range_) - 23;
      offset_ = (offset_ << n) | take(n);
      range_ <<= n;
      q_.shift(n);
    }
    return 0;
  }

  size_t bitpos() const { return bitpos_; }
  const Bytes& bytes() const { return q_.out_; }

  // I_PCM resume: the flushed verify stream length IS the byte offset of
  // the pcm samples within the payload; copy them through and restart both
  // the decoder window and the re-encoder queue after them
  void pcm_resume(size_t n) {
    size_t start = q_.out_.size();
    q_.out_.insert(q_.out_.end(), data_ + start, data_ + start + n);
    bitpos_ = (start + n) * 8;
    inext_ = start + n;
    iwin_ = 0;
    iav_ = 0;
    range_ = 510;
    offset_ = take(9);
    bitpos_ = (start + n) * 8 + 9;  // take() advanced it; keep exact count
    q_.reinit();
  }

 private:
  // 64-bit MSB-aligned input window: refills 8 bytes at a time (zeros past
  // the end, mirroring the decoder's zero-fill), replacing per-bit indexed
  // loads; bitpos_ counts CONSUMED bits (the billing/trace anchor)
  inline void refill() {
    if (inext_ + 8 <= size_) {
      // bulk path: one unaligned big-endian load refills the whole window
      uint64_t v;
      __builtin_memcpy(&v, data_ + inext_, 8);
      v = __builtin_bswap64(v);
      int take_bytes = (64 - iav_) >> 3;
      iwin_ |= v >> iav_;
      iav_ += take_bytes * 8;
      inext_ += take_bytes;
      return;
    }
    while (iav_ <= 56) {
      uint64_t b = inext_ < size_ ? data_[inext_] : 0;
      inext_++;
      iwin_ |= b << (56 - iav_);
      iav_ += 8;
    }
  }
  inline uint32_t take(int n) {
    if (n == 0) return 0;
    if (iav_ < n) refill();
    uint32_t v = (uint32_t)(iwin_ >> (64 - n));
    iwin_ <<= n;
    iav_ -= n;
    bitpos_ += n;
    return v;
  }
  void flush() {
    q_.shift(7);                 // range 2 -> 256 renorm (encoder side only)
    q_.shift(1);                 // (low >> 9) & 1
    q_.shift(1);                 // (low >> 8) & 1
    q_.low_ |= (uint64_t)1 << 9; // stop bit
    q_.shift(1);
    q_.finish();
  }

  const uint8_t* data_;
  size_t size_;
  size_t bitpos_ = 0;
  uint64_t iwin_ = 0;
  int iav_ = 0;
  size_t inext_ = 0;
  uint32_t range_, offset_;
  CabacByteQueue q_;  // fused bit-exact re-encoder (verify pass)
};

}  // namespace avtpu
