// One-pass lane packer: native trace records -> the compact lane problem
// the device lane coder takes (ops/lane_coder.py::pack_lanes).
//
// A trace of T bins splits into ceil(T / B) lanes of at most B bins (at
// least one); lane rows are Bp = B rounded up to 256 bins wide and hold their
// bins from column 0, zeros after.  Each u64 record is read once
// (lo32 = slot | bit << 24, hi32 = pcab | p1 << 16) and written as
//   index form  uint8 [L, 3 * Bp / 2]  two 12-bit squash-table indices in
//               three bytes, the even bin's in the low 12 bits (the JAX
//               package's pack_p1_idx layout), or
//   u16 form    uint16 [L, Bp]         p1 itself,
// plus the bit words int32 [L, Bp / 32] (little-endian) and lens int32 [L].
// The index form is written when every valid bin's p1 lies in the squash
// table's image (the recorder requantizes every p1 onto it, model.h); p1 = 0
// counts as outside it in a valid bin (only padding may hold 0, as index 0).
// Otherwise the same call writes the u16 form.  A second entry,
// avtpu_lane_pack_codes, reads the lane form's traces (2 bytes a bin: the
// squash index and the bin, host/src/avtpu.cc::LaneCodes) and writes the
// same index-form rows, copying each index.  Lanes are cut into runs of
// rows, one run a host thread.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "mix_tables.h"

namespace {

constexpr uint16_t kForeign = 0xFFFF;  // no squash index has this value

// p1 -> a squash index with kSquash[index] == p1 (the last such index, as
// numpy's rev[SQUASH] = arange(4096) leaves it), kForeign outside the image
// and for p1 = 0, which no valid bin may hold (padding is written as index 0
// without the table)
struct SquashRev {
  uint16_t idx[1 << 16];
  SquashRev() {
    std::fill(idx, idx + (1 << 16), kForeign);
    for (int i = 0; i < 4096; ++i) idx[avtpu::kSquash[i]] = (uint16_t)i;
  }
};

const SquashRev& squash_rev() {
  static const SquashRev rev;  // built once, thread-safe
  return rev;
}

// Where a row's bins come from: the u64 trace records (lo32 = slot | bit <<
// 24, hi32 = pcab | p1 << 16), their p1 mapped to an index by the reverse
// map, or the lane form's uint16 codes (bits 0-11 the squash index, bit 12
// the bin, bits 13-15 zero), whose index is copied
struct FromRecs {
  using Rec = uint64_t;
  const uint16_t* rev;
  uint32_t idx(uint64_t r) const { return rev[r >> 48]; }
  static uint32_t bit(uint64_t r) { return (uint32_t)(r >> 24) & 1; }
  static uint16_t p1(uint64_t r) { return (uint16_t)(r >> 48); }
};
struct FromCodes {
  using Rec = uint16_t;
  uint32_t idx(uint16_t c) const { return c & 0xFFFu; }
  static uint32_t bit(uint16_t c) { return (uint32_t)c >> 12; }
};

template <class Rec>
struct Lane {
  const Rec* rec;  // the lane's first record
  int n;           // its bins
};

// one lane row in the index form, a 32-bin block (48 bytes of indices, a
// bit word) at a time; false where a valid p1 is foreign
template <class Src>
bool pack_row_idx(const Lane<typename Src::Rec>& ln, int Bp, const Src& src,
                  uint8_t* pk, int32_t* bitw) {
  uint32_t bad = 0;
  for (int b0 = 0; b0 < Bp; b0 += 32) {
    const int cnt = std::max(0, std::min(32, ln.n - b0));
    if (cnt == 32) {  // a full block: 8 bins into 12 bytes, two stores
      const typename Src::Rec* r = ln.rec + b0;
      uint8_t* q = pk + 3 * (b0 >> 1);
      uint32_t word = 0;
      for (int g = 0; g < 4; ++g, r += 8, q += 12) {
        uint64_t i[8];
        for (int k = 0; k < 8; ++k) {
          i[k] = src.idx(r[k]);
          bad |= (uint32_t)i[k];
          word |= src.bit(r[k]) << (g * 8 + k);
        }
        const uint64_t lo = i[0] | i[1] << 12 | i[2] << 24 | i[3] << 36 |
                            i[4] << 48 | i[5] << 60;
        const uint32_t hi = (uint32_t)(i[5] >> 4 | i[6] << 8 | i[7] << 20);
        std::memcpy(q, &lo, 8);
        std::memcpy(q + 8, &hi, 4);
      }
      bitw[b0 >> 5] = (int32_t)word;
      continue;
    }
    uint32_t idx[32], word = 0;
    for (int k = 0; k < cnt; ++k) {
      const typename Src::Rec r = ln.rec[b0 + k];
      word |= src.bit(r) << k;
      idx[k] = src.idx(r);
      bad |= idx[k];
    }
    for (int k = cnt; k < 32; ++k) idx[k] = 0;
    uint8_t* q = pk + 3 * (b0 >> 1);
    for (int k = 0; k < 32; k += 2, q += 3) {
      q[0] = (uint8_t)idx[k];
      q[1] = (uint8_t)((idx[k] >> 8) | (idx[k + 1] << 4));
      q[2] = (uint8_t)(idx[k + 1] >> 4);
    }
    bitw[b0 >> 5] = (int32_t)word;
  }
  return (bad & 0xF000u) == 0;
}

// one lane row of records in the u16 form, a 32-bin block at a time
void pack_row_u16(const Lane<uint64_t>& ln, int Bp, uint16_t* p1,
                  int32_t* bitw) {
  for (int b0 = 0; b0 < Bp; b0 += 32) {
    const int cnt = std::max(0, std::min(32, ln.n - b0));
    uint32_t word = 0;
    for (int k = 0; k < cnt; ++k) {
      const uint64_t r = ln.rec[b0 + k];
      word |= FromRecs::bit(r) << k;
      p1[b0 + k] = FromRecs::p1(r);
    }
    for (int k = cnt; k < 32; ++k) p1[b0 + k] = 0;
    bitw[b0 >> 5] = (int32_t)word;
  }
}

// threads that over_rows runs n rows on: up to 16, at least 64 rows each
int row_threads(int64_t n) {
  const int nt = (int)std::min(16u, std::thread::hardware_concurrency());
  return (int)std::max<int64_t>(1, std::min<int64_t>(nt, (n + 63) / 64));
}

// run fn(lo, hi) over [0, n) rows in contiguous runs, one a thread
template <class Fn>
void over_rows(int64_t n, Fn fn) {
  const int nt = row_threads(n);
  if (nt == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  for (int k = 0; k < nt; ++k)
    pool.emplace_back(fn, n * k / nt, n * (k + 1) / nt);
  for (auto& t : pool) t.join();
}

// The lane rows of n_traces traces (see avtpu_lane_pack), into `lanes`
// and lens; false on bad shapes
template <class Rec>
bool cut_lanes(const Rec* const* recs, const int64_t* n_recs,
               const int64_t* lane0, int n_traces, int B, int Bp, int64_t L,
               std::vector<Lane<Rec>>* lanes, int32_t* lens) {
  if (B <= 0 || Bp < B || Bp % 32 || L < 0) return false;
  lanes->assign((size_t)L, Lane<Rec>{nullptr, 0});
  for (int t = 0; t < n_traces; ++t) {
    const int64_t n = n_recs[t];
    const int64_t k = std::max<int64_t>(1, (n + B - 1) / B);
    if (lane0[t] < 0 || lane0[t] + k > L) return false;
    for (int64_t j = 0; j < k; ++j)
      (*lanes)[(size_t)(lane0[t] + j)] = Lane<Rec>{
          recs[t] + j * B,
          (int)std::max<int64_t>(0, std::min<int64_t>(B, n - j * B))};
  }
  for (int64_t r = 0; r < L; ++r) lens[r] = (*lanes)[(size_t)r].n;
  return true;
}

}  // namespace

extern "C" {

// recs[t] / n_recs[t]: trace t's records; lane0[t]: its first row (rows are
// assigned in trace order, ceil(n / B) rows a trace, at least one).  Writes
// rows [0, L): the index form into `pk` (uint8 [L, 3 * Bp / 2]) and returns
// 1, or, where some valid p1 is outside the squash image, the u16 form into
// `p1` (uint16 [L, Bp]) and returns 0; `bitw` and `lens` either way.  Every
// byte of the form written is set (padding zero).  Returns -1 on bad shapes.
int avtpu_lane_pack(const uint64_t* const* recs, const int64_t* n_recs,
                    const int64_t* lane0, int n_traces, int B, int Bp,
                    int64_t L, uint8_t* pk, uint16_t* p1, int32_t* bitw,
                    int32_t* lens) {
  std::vector<Lane<uint64_t>> lanes;
  if (!cut_lanes(recs, n_recs, lane0, n_traces, B, Bp, L, &lanes, lens))
    return -1;
  const FromRecs src{squash_rev().idx};
  const size_t wp = 3 * (size_t)Bp / 2, ww = (size_t)Bp / 32;
  std::atomic<bool> foreign{false};
  over_rows(L, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi && !foreign.load(std::memory_order_relaxed);
         ++r)
      if (!pack_row_idx(lanes[(size_t)r], Bp, src, pk + r * wp,
                        bitw + r * ww))
        foreign.store(true, std::memory_order_relaxed);
  });
  if (!foreign.load()) return 1;
  over_rows(L, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r)
      pack_row_u16(lanes[(size_t)r], Bp, p1 + r * (size_t)Bp, bitw + r * ww);
  });
  return 0;
}

// avtpu_lane_pack over lane-form traces (codes[t] / n_codes[t], the uint16
// codes of avtpu_xlane): a code's index is its p1's squash index, always in
// the table, so the rows are the index form, each index copied; returns 1,
// or -1 on bad shapes.  The rows equal avtpu_lane_pack's on the same
// traces' u64 records.
int avtpu_lane_pack_codes(const uint16_t* const* codes,
                          const int64_t* n_codes, const int64_t* lane0,
                          int n_traces, int B, int Bp, int64_t L,
                          uint8_t* pk, int32_t* bitw, int32_t* lens) {
  std::vector<Lane<uint16_t>> lanes;
  if (!cut_lanes(codes, n_codes, lane0, n_traces, B, Bp, L, &lanes, lens))
    return -1;
  const size_t wp = 3 * (size_t)Bp / 2, ww = (size_t)Bp / 32;
  over_rows(L, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r)
      pack_row_idx(lanes[(size_t)r], Bp, FromCodes{}, pk + r * wp,
                   bitw + r * ww);
  });
  return 1;
}

// the host threads avtpu_lane_pack runs each pass on for L rows
int avtpu_lane_pack_threads(int64_t L) { return row_threads(L); }

}  // extern "C"
