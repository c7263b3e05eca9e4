// Lane-parallel range DECODER for Hopper (sm_90a).
//
// Computes what avrecode_tpu/ops/lane_decoder.py::lane_decode_scan computes
// (an XLA scan there, because the TPU's kernel language has no per-lane
// gather; a GPU thread indexes its own byte stream).  Every lane is one
// range-decoder stream given its per-bin probabilities:
//
//   stream uint8  [N]         all lanes' stream bytes, concatenated (N a
//                             multiple of 16, base 16-byte aligned)
//   offs   int64  [L + 1]     lane l owns stream[offs[l] : offs[l + 1]];
//                             values are clamped to [0, N] and to each
//                             other, so no offset can read out of bounds
//   p1     uint16 [L, Bp]     exact per-bin model probability of a 1
//                             (Bp a multiple of 32, base 16-byte aligned)
//   lens   int32  [L]         valid bins per lane
//   bitw   int32  [L, Bp/32]  decoded bits, little-endian 32-bit words; 0
//                             beyond lens (the kernel writes every word)
//
// A read past a lane's end yields a zero byte.  That is the normal case:
// the encoder strips trailing zeros, an empty lane has no byte at all, and
// the 4-byte big-endian start of `code` already reads past it.
//
// Bounds on this card.  Bytes: 2 B of p1 read and 1/8 B of bits written a
// bin, the stream bytes once: 0.3 GB and 0.1 ms at [8192, 16384] and
// 3.35 TB/s; the algorithm's integer operations (10 a bin and 7 a stream
// byte, chip_smoke.py's DECODE_OPS) take less.  The floor that binds is
// the chain: a lane is one serial
// recurrence over (code, rng), so Bp bins cost at least Bp times one bin's
// dependent instructions (rng >> 16, multiply, compare, select, find
// leading bit, shift; ~53 cycles), whatever the lane count: 0.44 ms at
// 16,384 bins.  Issue: a bin is ~25 integer instructions in the unrolled
// body (chip_sass.py), 2 cycles each on a scheduler's 16 integer lanes,
// ~50 cycles: below the chain.  Neither is what a warp reaches: its
// instructions issue in order, so a stall on the chain holds the side work
// behind it too (four warps alone on the card decode as slowly a bin as
// 512 warps).
//
// Design: one thread per lane, 16 lanes a warp, tile by tile (128 bins),
// as lane_encode.cu, whose p1 tile loader this is: coalesced cp.async
// copies into two shared-memory buffers, a lane's row padded by 16 bytes so
// the 16-byte reads of 8 neighbouring threads hit 32 different banks.
//   * The byte feed stays off the chain.  A thread keeps the next stream
//     bytes in a 64-bit window, most significant byte first, so a renorm
//     step is a funnel shift of (code : window) by 0, 8 or 16 bits; the
//     byte index never appears.  Every two bins (two bins take at most 32
//     bits) the window takes the word loaded at the last refill where it
//     has room for 32 bits, and the word after it is loaded: no branch, and
//     the load is used two bins after it was issued.  (An earlier version's
//     refill was a branch that loaded the word it was about to use: the
//     load's latency then sat on the chain every other bin and the branch
//     split the unrolled body: 0.774-0.783 ms at [8192, 16384] against
//     0.595-0.602, and one lane of 64,096 bins 2.50-2.51 ms against 2.24.)
//   * The words come from shared memory, never from global memory inside
//     the bin loop.  Each lane owns a 1 KB ring there, addressed by the
//     byte's offset in the stream buffer, which cp.async fills in 16-byte
//     chunks at the tile boundaries, in the same group as the next p1 tile:
//     what a lane can take in the next tile (2 bytes a bin) is asked for a
//     tile ahead and waited for with the p1 tile.  A chunk that reaches
//     past the lane's end is zero-filled from there by the copy itself
//     (its source size), so the loop has no bounds test at all; the bytes
//     before an unaligned start are shifted out at the beginning.  (The
//     first version loaded words with __ldg into registers two refills
//     ahead.  A warp waits on a register for all of its lanes, so with 16
//     lanes refilling at different bins nearly every refill met a load
//     still in flight: 1.20 ms at [8192, 16384], 73 ns a bin, where one
//     lane alone took 46 ns a bin; with the ring 0.77 ms and 39 ns.)
//   * Both renorm steps come from one find-leading-bit: with rng >= 2^24
//     before the bin, the new rng is >= 2^8 for every p1 (a 1 needs
//     code < r1, which p1 = 0 never gives), so its leading zeros are 0..23
//     and the shift is lz & 24.
//   * Bits collect in a register and leave as one 32-bit word per 32 bins.
//     A warp stops loading p1 after the last tile that any of its lanes
//     needs and writes zero words from there on.
// Also tried: 32 lanes a warp (0.628 ms: half the warps, each as
// slow); a table of the stream's byte pairs built at the top of each tile,
// so that a bin reads its two next bytes by position and no window exists
// (20 instructions a bin against 25, but 0.713 ms: the table load is on
// the chain).  The decoder's chain cannot be split between two warps
// (`one = code < r1` couples code and rng), and all that could leave it is
// the refill, which is a quarter of its instructions.  Times are
// chip_variants.py's, all versions in one call on an NVIDIA H100 80GB HBM3
// at 700 W.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;                   // lanes a warp
constexpr int kTileBins = 128;              // bins a lane, per tile
constexpr int kP1Row = kTileBins * 2 + 16;  // bytes, padded
constexpr int kP1Tile = kRows * kP1Row;     // 4,352
constexpr int kRing = 1024;                 // stream bytes a lane holds
// A tile takes at most 128 x 16 bits and ends with at most 64 in the
// window and one word loaded ahead of it: 67 words, 268 bytes.  Asking, at
// the top of tile t, for the bytes up to 2 x 268 past the next word covers
// tile t + 1 wherever tile t ends, and the span in flight (536 + 2 x 15 for
// the chunks' alignment) fits the ring without touching a byte still to be
// read.
constexpr int kAhead = 536;

struct LaneState {
  uint32_t code, rng;
  uint64_t win;    // upcoming stream bytes, the next one on top
  int bits;        // valid bits in win
  uint32_t roff;   // ring offset of the next word (its buffer offset % kRing)
  uint32_t next;   // that word, first byte on top, loaded a refill ahead
};

// The word at ring offset `off`, first byte on top.
__device__ __forceinline__ uint32_t ring_word(const unsigned char* ring,
                                              uint32_t off) {
  return __byte_perm(*reinterpret_cast<const uint32_t*>(ring + off), 0u, 0x0123);
}

// Branch-free: where the window has room for a word, the word loaded a
// refill ago goes in and the one after it is loaded; elsewhere the same
// word is loaded again.  The load is needed two bins later, so its latency
// stays off the chain.
__device__ __forceinline__ void refill(LaneState& st, const unsigned char* ring) {
  const bool room = st.bits <= 32;
  st.win |= static_cast<uint64_t>(room ? st.next : 0u) << ((32 - st.bits) & 63);
  st.bits += room ? 32 : 0;
  st.roff = (st.roff + (room ? 4u : 0u)) & (kRing - 1);
  st.next = ring_word(ring, st.roff);
}

// 8 bins of one lane: p1 as four packed pairs.  Returns the 8 decoded bits.
// kCheck: only the first n_live bins are valid; the others leave the state
// alone and decode to 0.
template <bool kCheck>
__device__ __forceinline__ uint32_t decode8(LaneState& st, const uint4 pv,
                                            int n_live,
                                            const unsigned char* ring) {
  const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
  uint32_t out = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if ((k & 1) == 0) refill(st, ring);  // >= 32 bits for two bins
    const uint32_t p1 = (k & 1) ? pw[k >> 1] >> 16 : pw[k >> 1] & 0xFFFFu;
    const uint32_t r1 = (st.rng >> 16) * p1;
    const bool one = st.code < r1;
    const uint32_t rng_n = one ? r1 : st.rng - r1;
    const uint32_t code_n = one ? st.code : st.code - r1;
    uint32_t lz;
    asm("bfind.shiftamt.u32 %0, %1;" : "=r"(lz) : "r"(rng_n));
    const uint32_t sh = lz & 24u;  // 0, 8 or 16: both renorm steps
    if (!kCheck || k < n_live) {
      st.code = __funnelshift_l(static_cast<uint32_t>(st.win >> 32), code_n, sh);
      st.rng = rng_n << sh;
      st.win <<= sh;
      st.bits -= static_cast<int>(sh);
      out |= (one ? 1u : 0u) << k;
    }
  }
  return out;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// 16 bytes of which the first n (0..16) come from src and the rest are 0.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__global__ void __launch_bounds__(32)
lane_decode_kernel(const unsigned char* __restrict__ stream, long long n_bytes,
                   const long long* __restrict__ offs,
                   const uint16_t* __restrict__ p1,
                   const int32_t* __restrict__ lens,
                   uint32_t* __restrict__ bitw, int L, int Bp) {
  __shared__ __align__(16) unsigned char s_p1[2 * kP1Tile];
  __shared__ __align__(16) unsigned char s_ring[kRows * kRing];

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kRows;  // first lane of this warp
  const int lane = lane0 + tid;
  const int rows = min(kRows, L - lane0);  // lanes this warp owns
  const bool mine = tid < rows;            // this thread decodes a lane
  const int wpr = Bp / 32;                 // words a row

  int n_valid = 0;
  long long start = 0, end = 0;
  if (mine) {
    n_valid = lens[lane];
    n_valid = n_valid < 0 ? 0 : (n_valid > Bp ? Bp : n_valid);
    start = offs[lane];
    start = start < 0 ? 0 : (start > n_bytes ? n_bytes : start);
    end = offs[lane + 1];
    end = end < start ? start : (end > n_bytes ? n_bytes : end);
  }
  // tiles that some lane of this warp still decodes in
  const int n_max = __reduce_max_sync(0xFFFFFFFFu, n_valid);
  const int nt = (n_max + kTileBins - 1) / kTileBins;
  if (nt == 0) {  // no valid bin in the warp
    if (mine)
      for (int w = 0; w < wpr; ++w)
        bitw[static_cast<size_t>(lane) * wpr + w] = 0u;
    return;
  }

  // this lane's ring, and the stream bytes asked for so far: [.., req)
  unsigned char* ring = s_ring + (mine ? tid : 0) * kRing;
  long long req = start & ~15ll;
  auto ring_request = [&](long long upto) {
    while (mine && req < upto) {
      const long long left = end - req;  // bytes of the lane from req on
      const int n = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
      cp_async16_zfill(ring + (req & (kRing - 1)), stream + (n ? req : 0), n);
      req += 16;
    }
  };

  // the first 12 bytes from the aligned word that holds `start`: shift the
  // bytes before `start` out, take 4 bytes as code, keep the rest
  long long next = (start & ~3ll) + 12;  // buffer offset of the next word
  ring_request(next + kAhead);
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  LaneState st{0u, 0xFFFFFFFFu, 0ull, 0, 0u, 0u};
  if (mine) {
    const uint32_t r0 = static_cast<uint32_t>(start & ~3ll) & (kRing - 1);
    const int s = 8 * static_cast<int>(start & 3);
    const uint32_t a = ring_word(ring, r0);
    const uint32_t b = ring_word(ring, (r0 + 4u) & (kRing - 1));
    const uint32_t c = ring_word(ring, (r0 + 8u) & (kRing - 1));
    st.code = __funnelshift_l(b, a, s);
    st.win = (static_cast<uint64_t>(__funnelshift_l(c, b, s)) << 32) |
             (static_cast<uint64_t>(c << s));
    st.bits = 64 - s;
    st.roff = (r0 + 12u) & (kRing - 1);
    st.next = ring_word(ring, st.roff);
  }
  uint32_t roff_seen = st.roff;  // st.roff when `next` was brought up to date

  // tile t of p1 -> buffer t & 1: 16-byte chunks, neighbouring threads on
  // neighbouring chunks of a lane's row; in the same group, the stream
  // bytes this lane can take up to the end of tile t
  auto load_tile = [&](int t) {
    next += (st.roff - roff_seen) & (kRing - 1);
    roff_seen = st.roff;
    ring_request(next + kAhead);
    const int b0 = t * kTileBins;
    const int cpr = min(kTileBins, Bp - b0) / 8;  // chunks a row (Bp % 32 == 0)
    unsigned char* buf = s_p1 + (t & 1) * kP1Tile;
    const int c = tid & 15;  // two rows a pass, 16 chunks each
    if (c < cpr)
      for (int r = tid >> 4; r < rows; r += 2)
        cp_async16(buf + r * kP1Row + c * 16,
                   p1 + static_cast<size_t>(lane0 + r) * Bp + b0 + c * 8);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  uint32_t* orow = bitw + static_cast<size_t>(mine ? lane : 0) * wpr;
  load_tile(0);
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
    for (int w = 0; mine && w < tw / 32; ++w) {
      uint32_t word = 0u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int i = w * 32 + g * 8;  // bin inside the tile
        const int n_live = n_valid - (b0 + i);
        if (n_live <= 0) continue;
        const uint4 pv = *reinterpret_cast<const uint4*>(prow + i * 2);
        const uint32_t got = n_live >= 8
                                 ? decode8<false>(st, pv, 8, ring)
                                 : decode8<true>(st, pv, n_live, ring);
        word |= got << (g * 8);
      }
      orow[b0 / 32 + w] = word;
    }
    __syncwarp();  // before the next load overwrites this tile's buffer
  }
  // no lane of the warp has a valid bin from here on
  if (mine)
    for (int w = nt * (kTileBins / 32); w < wpr; ++w) orow[w] = 0u;
}

}  // namespace

extern "C" int lane_decode_launch(const void* stream, long long n_bytes,
                                  const void* offs, const void* p1,
                                  const void* lens, void* bitw, int L, int Bp,
                                  void* cuda_stream) {
  lane_decode_kernel<<<(L + kRows - 1) / kRows, 32, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const unsigned char*>(stream), n_bytes,
      static_cast<const long long*>(offs), static_cast<const uint16_t*>(p1),
      static_cast<const int32_t*>(lens), static_cast<uint32_t*>(bitw), L, Bp);
  return static_cast<int>(cudaGetLastError());
}
