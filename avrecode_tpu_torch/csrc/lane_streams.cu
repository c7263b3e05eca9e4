// Lane-parallel range encoder with the finalize fused in, for Hopper (sm_90a).
//
// Replaces avrecode_tpu/ops/lane_coder.py::_lane_pipeline_jit, which runs
// the Pallas kernel _lane_kernel and the XLA program _finalize_device in one
// jitted call: from the compact device upload straight to every lane's
// resolved stream bytes.  The [L, Bp] tokens and carry counts (8 B a bin)
// that lane_encode.cu stores and a finalize reads back never exist here.
//
//   p1     uint16 [L, Bp]       exact per-bin model probability of a 1
//                               (Bp a multiple of 32, base 16-byte aligned)
//   bitw   int32  [L, Bp / 32]  the bins' bits, little-endian 32-bit words
//   lens   int32  [L]           valid bins per lane (bins past it are frozen)
//   out    uint8  [L, M]        the lane's stream bytes (M a multiple of 8);
//                               bytes at and past nbytes are unspecified
//   nbytes int32  [L]           length of the lane's stream
//   total  int32  [L]           bytes the lane emitted, the two flush bytes
//                               included; total > M: the lane ran past the
//                               bound, its out row and nbytes mean nothing
//
// Bounds on this card.  Bytes: 2 + 1/8 B read a bin, at most M written a
// lane: 285 MB + 34 MB at [8192, 16384] with M = 4104, 0.095 ms at 3.35
// TB/s.  The floor that counts is the chain, as in lane_encode.cu: a lane
// is one serial recurrence over (low, rng, pend), so Bp bins cost Bp times
// one bin's dependent steps (~53 cycles), 0.44 ms at 16,384 bins.
//
// Design: one thread per lane, 16 lanes a warp, 128-bin tiles of p1 and bit
// words through two cp.async buffers, the chain of lane_encode.cu bin for
// bin.  What a bin emits does not go out as a token; the lane's thread owns
// its stream from the first bin to the last byte:
//   * Compaction as it goes, carries in a register.  A token's
//     pending-carry count belongs to the byte before its byte0, and one
//     emitted byte in five or ten receives one: that is no rare event.  So
//     the newest byte is held in a register until the next token arrives,
//     takes that token's count there, and only then counts as final.  A
//     bin stores two 16-bit elements into a ring of 512 positions in shared
//     memory, whatever it emitted: the held byte plus the count at the
//     position before the write position, and its own byte0 (with its count
//     in bits 12-13) at the write position; the position moves on by the 0,
//     1 or 2 bytes really emitted, and what was not is overwritten by the
//     next bin.  Two stores, a select and two adds beyond the chain, no
//     branch.  (Tried first: raw bytes in the ring and a queue of carries
//     filled under `if (carry)`, 1.05 ms at [8192, 16384], of which the
//     branch was 0.27, since it cuts the unrolled body into blocks, and a
//     last-flushable position kept bin by bin 0.10; then the counts in the
//     ring's elements and every one of them resolved after the tile, 1.57
//     ms, 0.75 of it that pass: a warp walks through its 16 lanes' carries
//     one after another.)
//   * After a tile the lane's thread settles the tile's new bytes.  The
//     last one whose raw byte is not 0xFF or whose token held a carry is
//     where the truncation rule will cut (nearly always the newest byte:
//     a backward scan of one step).  Then the overflows, found 8 elements
//     a read: a final byte that was 0xFF and took a count stands above 0xFF
//     (one byte in a thousand); the thread takes the excess off and ripples
//     it base-256 toward lower positions.  The tile's own bytes are still
//     in the ring; a run of 0xFF that reaches below them is patched in
//     global memory, in pieces the warp stored after earlier tiles and will
//     not store again.  A carry into the byte before position 0 is dropped,
//     as the reference drops it.
//   * Then the whole warp stores every lane's complete 8-byte pieces to
//     global memory (two threads a row, 8 elements packed to 8 bytes), so
//     no thread writes single bytes there; the piece of the held byte
//     waits.  A tile emits at most 256 bytes a lane and at most 8 wait for
//     their piece, so the ring never wraps onto bytes not yet stored.  M is
//     a multiple of 8, so a piece never straddles column M, and nothing is
//     stored at or past it; the position keeps counting.
//   * After the flush pair the thread scans its own resolved bytes backward
//     from the cut for the last non-zero one; a running "last non-zero"
//     would be wrong, since a ripple turns 0xFF into 0x00.
//   * A warp codes only as many tiles as its longest lane has bins.
// The settling and the last scan are serial for the warp, and short; a
// ripple that walks through a long run of 0xFF in global memory pays a
// memory round trip a byte (64 lanes that each walk ~1,500 bytes: 2.5 ms).
//
// Two switches take a piece out, for chip_variants.py to time what it costs
// (the output is then wrong): -DSTREAMS_NO_SETTLE skips the pass after a
// tile, -DSTREAMS_NO_RING the two ring stores of a bin.  At [8192, 16384]:
// 0.81 ms whole, 0.75 without the pass, 0.615 without both; lane_encode.cu
// with its 8 B a bin of token stores takes 0.61-0.65.  All times are of
// sources run by chip_variants.py on an NVIDIA H100 80GB HBM3 at 700 W.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRows = 16;                     // lanes a warp
constexpr int kTileBins = 128;                // bins a lane, per tile
constexpr int kP1Row = kTileBins * 2 + 16;    // bytes: p1, then bit words
constexpr int kP1Tile = kRows * kP1Row;       // 4,352
constexpr int kPiece = 8;                     // bytes of one global store
constexpr int kRing = 512;                    // positions of a lane's ring
constexpr int kRingRow = kRing + 8;           // elements, padded: other banks
constexpr int kRingTile = kRows * kRingRow * 2;     // 16,640 bytes
constexpr int kSmemBytes = 2 * kP1Tile + kRingTile;  // 25,344

constexpr uint32_t kValue = 0x3FFu;  // an element's byte, with its excess
constexpr int kCountShift = 12;      // the token's carry count above it

struct LaneState {
  uint32_t low, rng, pend;
  int pos;        // bytes emitted so far = where the next byte goes
  uint32_t held;  // the element at pos - 1: it may still take a carry
};

// 8 bins of one lane: p1 as four packed pairs, the bits in the low byte of
// `bits`.  kCheck: only the first n_live of them are valid.  The chain is
// lane_encode.cu's code8, step for step.
template <bool kCheck>
__device__ __forceinline__ void code8(LaneState& st, const uint4 pv,
                                      uint32_t bits, int n_live,
                                      uint16_t* ring) {
  const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (kCheck && k >= n_live) continue;
    const uint32_t p1 = (k & 1) ? pw[k >> 1] >> 16 : pw[k >> 1] & 0xFFFFu;
    const bool one = (bits & (1u << k)) != 0u;
    const uint32_t r1 = (st.rng >> 16) * p1;
    const uint32_t rng_n = one ? r1 : st.rng - r1;
    const uint64_t pl = ((static_cast<uint64_t>(st.pend) << 32) | st.low) +
                        (one ? 0u : r1);
    const uint32_t low_n = static_cast<uint32_t>(pl);
    const uint32_t pend_n = static_cast<uint32_t>(pl >> 32);
    // both renorm byte shifts from one find-leading-bit (0, 8 or 16); p1 = 0
    // makes rng_n 0 and takes two shifts, as the plain version does
    uint32_t lz;
    asm("bfind.shiftamt.u32 %0, %1;" : "=r"(lz) : "r"(rng_n));
    const uint32_t sh_rng = lz & 24u;
    const uint32_t sh = min(lz, 16u) & 24u;
    const bool do0 = sh != 0u;
    // the token's pending-carry count goes to the held byte (low wraps at
    // most once between two emissions, so it is 0 or 1; 0 where nothing is
    // emitted); then the bytes a renorm would emit: low's top byte with the
    // count above it, and the next byte, which becomes the held one
    const uint32_t c = do0 ? pend_n : 0u;
    const uint32_t e0 = (low_n >> 24) + (c << kCountShift);
    const uint32_t e1 = (low_n >> 16) & 0xFFu;
#ifndef STREAMS_NO_RING
    ring[(st.pos - 1) & (kRing - 1)] = static_cast<uint16_t>(st.held + c);
    ring[st.pos & (kRing - 1)] = static_cast<uint16_t>(e0);
#endif
    st.held = sh == 16u ? e1 : (do0 ? e0 : st.held);
    st.pos += static_cast<int>(sh >> 3);
    st.low = low_n << sh;
    st.rng = rng_n << sh_rng;
    st.pend = do0 ? 0u : pend_n;
  }
}

// Settle the bytes a lane emitted at positions [from, to), all still in the
// ring; the one at to - 1 is the held byte, those below it are final.
// Returns the truncation cut: the last of them whose raw byte is not 0xFF or
// whose token held a carry, or `cut` if there is none.  (The scan goes on
// only past tokens without a carry, so every byte it looks at is raw.)  Then
// takes the excess off every final byte that stands above 0xFF, from the
// byte that was held before this tile on, and ripples it toward lower
// positions.  Positions from `stored` on are in the ring; those below were
// stored by the warp after earlier tiles and are patched in the lane's row
// of `out` (never at or past column M: such a lane is past the bound and
// its row means nothing).
__device__ __noinline__ int settle(uint16_t* ring, volatile unsigned char* row,
                                   int from, int to, int stored, int M,
                                   int cut) {
  for (int j = to - 1; j >= from; --j) {
    const uint32_t e = ring[j & (kRing - 1)];
    if ((e & kValue) != 0xFFu || (e >> kCountShift) != 0u) {
      cut = j;
      break;
    }
  }
  const int first = max(from - 1, 0);
  for (int g = first & ~7; g < to; g += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(ring + (g & (kRing - 1)));
    if (((v.x | v.y | v.z | v.w) & 0x03000300u) == 0u) continue;
    for (int j = max(g, first); j < min(g + 8, to); ++j) {
      uint16_t* q = ring + (j & (kRing - 1));
      uint32_t carry = (*q & kValue) >> 8;
      *q &= 0xF0FFu;
      for (int i = j - 1; carry != 0u && i >= 0; --i) {
        if (i >= stored) {
          uint16_t* p = ring + (i & (kRing - 1));
          const uint32_t x = (*p & 0xFFu) + carry;
          *p = static_cast<uint16_t>((*p & 0xF000u) | (x & 0xFFu));
          carry = x >> 8;
        } else {
          if (i >= M) break;
          const uint32_t x = row[i] + carry;
          row[i] = static_cast<unsigned char>(x);
          carry = x >> 8;
        }
      }
    }
  }
  return cut;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(32)
lane_encode_streams_kernel(const uint16_t* __restrict__ p1,
                           const uint32_t* __restrict__ bitw,
                           const int32_t* __restrict__ lens,
                           unsigned char* out, int32_t* __restrict__ nbytes,
                           int32_t* __restrict__ total, int L, int Bp, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_p1 = smem;                  // two p1 tiles
  uint16_t* s_ring = reinterpret_cast<uint16_t*>(smem + 2 * kP1Tile);

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kRows;  // first lane of this warp
  const int lane = lane0 + tid;
  const int rows = min(kRows, L - lane0);  // lanes this warp owns
  const bool owner = tid < rows;           // this thread codes a lane

  int n_valid = 0;
  if (owner) {
    n_valid = lens[lane];
    n_valid = n_valid < 0 ? 0 : (n_valid > Bp ? Bp : n_valid);
  }
  // tiles of the warp's longest lane; the bins past it are never read
  const int nt = (__reduce_max_sync(kFull, n_valid) + kTileBins - 1) / kTileBins;

  // tile t of p1 -> buffer t & 1: 16-byte chunks, neighbouring threads on
  // neighbouring chunks of a lane's row; the bit words go into the 16 bytes
  // that pad the row
  auto load_tile = [&](int t) {
    const int b0 = t * kTileBins;
    const int cpr = min(kTileBins, Bp - b0) / 8;  // chunks a row (Bp % 32 == 0)
    unsigned char* buf = s_p1 + (t & 1) * kP1Tile;
    const int c = tid & 15;  // two rows a pass, 16 chunks each
    if (c < cpr)
      for (int r = tid >> 4; r < rows; r += 2)
        cp_async16(buf + r * kP1Row + c * 16,
                   p1 + static_cast<size_t>(lane0 + r) * Bp + b0 + c * 8);
    if (owner)
      for (int w = 0; w < cpr / 4; ++w)
        cp_async4(buf + tid * kP1Row + kTileBins * 2 + w * 4,
                  bitw + static_cast<size_t>(lane) * (Bp / 32) + b0 / 32 + w);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  LaneState st{0u, 0xFFFFFFFFu, 0u, 0, 0u};
  int stored = 0;  // the lane's bytes below this are in global memory
  int cut = 0;     // where the truncation rule cuts the stream
  uint16_t* ring = s_ring + (tid & (kRows - 1)) * kRingRow;  // a ring a lane
  unsigned char* row = out + static_cast<size_t>(owner ? lane : lane0) * M;

  // the warp stores every lane's pieces from `stored` up to `upto` (both
  // multiples of 8), two threads a row, nothing at or past column M
  auto store_pieces = [&](int upto) {
    const int r = tid >> 1;
    const int from = __shfl_sync(kFull, stored, r);
    const int to = min(__shfl_sync(kFull, upto, r), M);
    if (r < rows) {
      const uint16_t* src = s_ring + r * kRingRow;
      unsigned char* dst = out + static_cast<size_t>(lane0 + r) * M;
      for (int j = from + (tid & 1) * kPiece; j < to; j += 2 * kPiece) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(src + (j & (kRing - 1)));
        *reinterpret_cast<uint2*>(dst + j) = make_uint2(
            __byte_perm(v.x, v.y, 0x6420), __byte_perm(v.z, v.w, 0x6420));
      }
    }
  };

  if (nt > 0) load_tile(0);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      load_tile(t + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();

    const int b0 = t * kTileBins;
    const int tw = min(kTileBins, Bp - b0);  // bins of this tile
    const unsigned char* prow = s_p1 + (t & 1) * kP1Tile + tid * kP1Row;
    const int from = st.pos;
    for (int w = 0; owner && w < tw / 32 && b0 + w * 32 < n_valid; ++w) {
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(prow + kTileBins * 2 + w * 4);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int i = w * 32 + g * 8;  // bin inside the tile
        const uint4 pv = *reinterpret_cast<const uint4*>(prow + i * 2);
        const int n_live = n_valid - (b0 + i);
        if (n_live >= 8)
          code8<false>(st, pv, word >> (g * 8), 8, ring);
        else
          code8<true>(st, pv, word >> (g * 8), n_live, ring);
      }
    }
    if (st.pos != from) {
      ring[(st.pos - 1) & (kRing - 1)] = static_cast<uint16_t>(st.held);
#ifndef STREAMS_NO_SETTLE
      cut = settle(ring, row, from, st.pos, stored, M, cut);
#endif
    }
    __syncwarp();
    // all final bytes, in whole pieces: not the held byte's piece
    const int upto = max(st.pos - 1, 0) & ~(kPiece - 1);
    store_pieces(upto);
    stored = upto;
    __syncwarp();  // before the next tile overwrites the p1 buffer
  }

  if (owner) {
    // shortest-terminator flush from the frozen state: round low up to the
    // next 2^24 multiple, then two byte shifts
    const uint32_t low_r = (st.low + (kTop - 1)) & 0xFF000000u;
    const uint32_t fc = st.pend + (low_r < st.low ? 1u : 0u);
    ring[(st.pos - 1) & (kRing - 1)] = static_cast<uint16_t>(st.held + fc);
    ring[st.pos & (kRing - 1)] =
        static_cast<uint16_t>((low_r >> 24) + (fc << kCountShift));
    ring[(st.pos + 1) & (kRing - 1)] =
        static_cast<uint16_t>((low_r >> 16) & 0xFFu);
    st.pos += 2;
    cut = settle(ring, row, st.pos - 2, st.pos, stored, M, cut);
  }
  __syncwarp();
  // the last, partly filled piece too; what lies past the stream's end in
  // it is unspecified
  store_pieces((st.pos + kPiece - 1) & ~(kPiece - 1));
  __syncwarp();

  if (owner) {
    // truncation: the stream ends at the cut (exclusive), less its trailing
    // zeros, read from the resolved bytes the warp has just stored
    int nb = 0;
    if (st.pos <= M) {
      const volatile unsigned char* bytes = row;
      for (int j = cut - 1; j >= 0; --j)
        if (bytes[j] != 0) {
          nb = j + 1;
          break;
        }
    }
    nbytes[lane] = nb;
    total[lane] = st.pos;
  }
}

}  // namespace

extern "C" int lane_encode_streams_launch(const void* p1, const void* bitw,
                                          const void* lens, void* out,
                                          void* nbytes, void* total, int L,
                                          int Bp, int M, void* stream) {
  lane_encode_streams_kernel<<<(L + kRows - 1) / kRows, 32, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(p1), static_cast<const uint32_t*>(bitw),
      static_cast<const int32_t*>(lens), static_cast<unsigned char*>(out),
      static_cast<int32_t*>(nbytes), static_cast<int32_t*>(total), L, Bp, M);
  return static_cast<int>(cudaGetLastError());
}
