// Lane-parallel estimator-free range encoder for Hopper (sm_90a).
//
// Replaces avrecode_tpu/ops/lane_coder.py::_lane_kernel (the Pallas TPU
// kernel launched by _lane_encode_pallas_jit).  Same inputs as the compact
// device upload of the main path, same outputs bit for bit:
//
//   p1   uint16 [L, Bp]       exact per-bin model probability of a 1
//                             (Bp a multiple of 32, base 16-byte aligned)
//   bitw int32  [L, Bp / 32]  the bins' bits, little-endian 32-bit words
//   lens int32  [L]           valid bins per lane (bins past it are frozen)
//   tok  int32  [L, Bp]       byte0 | byte1 << 8 | n_emitted << 16
//   car  int32  [L, Bp]       pending-carry count attached to byte0
//   ftok int32  [L]           flush bytes byte0 | byte1 << 8
//   fcar int32  [L]           pending-carry count of the flush byte0
//
// Bounds on this card.  Bytes: 2 + 1/8 B read and 8 B written a bin, 1,359 MB
// at [8192, 16384], 0.41 ms at 3.35 TB/s; the algorithm's integer
// operations (14 a bin and 8 a stream byte, chip_smoke.py's LANE_OPS) are
// less.  The second floor is the chain: every lane is one range-coder
// stream, a serial recurrence over (low, rng, pend), so Bp bins cost at
// least Bp times one bin's dependent instructions, whatever the lane count
// (measured on the card: ~5 cycles for an integer instruction or a
// multiply-add, ~18 for the find-leading-bit, ~29 for a shared-memory load).
//
// Design: one thread per lane, tile by tile (a warp's lanes x 128 bins).
//   * The tile of p1 and of bit words comes into shared memory with
//     coalesced cp.async copies, two buffers, so the next tile loads while
//     this one is coded.  A lane's row in the tile is padded by 16 bytes,
//     which puts the 16-byte reads of 8 neighbouring threads (one
//     shared-memory wavefront) on 32 different banks; the pad holds the
//     row's four bit words.  (Bit words read straight from global memory,
//     one word 32 bins ahead, stalled the chain on a DRAM round trip every
//     128 bins: 0.69 ms against 0.61 ms at [8192, 16384].)
//   * tok and car are written as 16-byte vectors into shared-memory tiles
//     (rows padded the same way) and stored by the whole warp in 512-byte
//     row segments: every global store instruction writes whole 128-byte
//     lines, where one thread per row wrote 32 sectors for 128 bytes of
//     payload before.
//   * Little sits on the chain: rng >> 16, the multiply, the subtract and
//     the select on the bit, then ONE find-leading-bit gives the shift of
//     both renorm steps (0, 8 or 16: clz & 24), and the shift.  The carry
//     out of low goes into pend by a 64-bit add of (pend : low); the token
//     is one byte permute.  The bit comes from a shared-memory word, p1
//     from a 16-byte shared-memory read 8 bins ahead.
//   * Bins past lens are written as zeros through the same tiles; a group
//     of 8 bins that lies wholly inside lens runs without the per-bin test.
//
// A warp owns 16 lanes, not 32.  A full group of 8,192 lanes then makes 512
// warps for the card's 528 warp schedulers; with 32 lanes a warp half of
// the schedulers stood idle while the others ran one warp each at the
// speed of its own instruction stream (0.67 ms against 0.61 ms; 8 lanes a
// warp: 1.16 ms).  Nothing hides a warp's chain but the instruction-level
// parallelism of its own thread, so the loop is unrolled by 8 and the next
// bins' side work runs in the shadow of this bin's chain.  Also tried:
// both renorm tests as two compares and nested selects instead of the
// find-leading-bit (0.77 against 0.80 ms at 32 lanes a warp, but 1.02
// against 0.95 ms on 55 lanes, where only the chain counts); the bit folded
// into the multipliers of two multiply-adds in place of the subtract, the
// select and the 64-bit add (0.70 against 0.69 ms: the time follows neither
// the chain's length nor the instruction count alone).  Times are of
// variants run by chip_variants.py on an NVIDIA H100 80GB HBM3 at 700 W.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kRows = 16;                         // lanes a warp
constexpr int kTileBins = 128;                    // bins a lane, per tile
constexpr int kP1Row = kTileBins * 2 + 16;        // bytes: p1, then bit words
constexpr int kOutRow = kTileBins * 4 + 16;       // bytes, padded
constexpr int kP1Tile = kRows * kP1Row;           // 4,352
constexpr int kOutTile = kRows * kOutRow;         // 8,448
constexpr int kSmemBytes = 2 * kP1Tile + 2 * kOutTile;  // 25,600

struct LaneState {
  uint32_t low, rng, pend;
};

// 8 bins of one lane: p1 as four packed pairs, the bits in the low byte of
// `bits`.  kCheck: only the first n_live of them are valid.
template <bool kCheck>
__device__ __forceinline__ void code8(LaneState& st, const uint4 pv,
                                      uint32_t bits, int n_live, uint4* tokv,
                                      uint4* carv) {
  const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
  uint32_t tk[8], cr[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t p1 = (k & 1) ? pw[k >> 1] >> 16 : pw[k >> 1] & 0xFFFFu;
    const bool one = (bits & (1u << k)) != 0u;
    const uint32_t r1 = (st.rng >> 16) * p1;
    // a 1 takes r1 as the new range and leaves low alone; a 0 takes
    // rng - r1 and adds r1 to low, whose carry out of 32 bits goes
    // straight into pend: (pend : low) is one 64-bit add
    const uint32_t rng_n = one ? r1 : st.rng - r1;
    const uint64_t pl = ((static_cast<uint64_t>(st.pend) << 32) | st.low) +
                        (one ? 0u : r1);
    const uint32_t low_n = static_cast<uint32_t>(pl);
    const uint32_t pend_n = static_cast<uint32_t>(pl >> 32);
    // both renorm byte shifts at once: with p1 >= 1, rng_n >= 2^8, so its
    // leading zeros are 0..23 and the shift is 0 (rng_n >= 2^24), 8, or 16
    // (rng_n < 2^16, where the second shift fires too).  p1 = 0, which no
    // model gives, makes rng_n 0 (all ones from bfind): two shifts, as the
    // plain version takes then.  That case is kept off the chain: rng stays
    // 0 under any shift, so rng takes lz & 24 as it comes
    uint32_t lz;
    asm("bfind.shiftamt.u32 %0, %1;" : "=r"(lz) : "r"(rng_n));
    const uint32_t sh_rng = lz & 24u;
    const uint32_t sh = min(lz, 16u) & 24u;
    const bool do0 = sh != 0u;
    const uint32_t n = sh >> 3;
    // tok = byte0 | byte1 << 8 | n << 16; the byte fields are taken whether
    // or not the renorm fires, exactly as the TPU kernel computes them:
    // byte0 is low's top byte, byte1 the next one if the first shift fired
    const uint32_t t = __byte_perm(low_n, n, do0 ? 0x5423u : 0x5433u);
    const uint32_t c = do0 ? pend_n : 0u;
    if (kCheck && k >= n_live) {
      tk[k] = 0u;
      cr[k] = 0u;
    } else {
      tk[k] = t;
      cr[k] = c;
      st.low = low_n << sh;
      st.rng = rng_n << sh_rng;
      st.pend = do0 ? 0u : pend_n;
    }
  }
  tokv[0] = make_uint4(tk[0], tk[1], tk[2], tk[3]);
  tokv[1] = make_uint4(tk[4], tk[5], tk[6], tk[7]);
  carv[0] = make_uint4(cr[0], cr[1], cr[2], cr[3]);
  carv[1] = make_uint4(cr[4], cr[5], cr[6], cr[7]);
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
lane_encode_kernel(const uint16_t* __restrict__ p1,
                   const uint32_t* __restrict__ bitw,
                   const int32_t* __restrict__ lens,
                   int32_t* __restrict__ tok, int32_t* __restrict__ car,
                   int32_t* __restrict__ ftok, int32_t* __restrict__ fcar,
                   int L, int Bp) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_p1 = smem;                   // two p1 tiles
  unsigned char* s_tok = smem + 2 * kP1Tile;    // one tok tile
  unsigned char* s_car = s_tok + kOutTile;      // one car tile

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kRows;  // first lane of this warp
  const int lane = lane0 + tid;
  const int rows = min(kRows, L - lane0);  // lanes this warp owns
  const int nt = (Bp + kTileBins - 1) / kTileBins;

  // tile t of p1 -> buffer t & 1: 16-byte chunks, neighbouring threads on
  // neighbouring chunks of a lane's row
  auto load_tile = [&](int t) {
    const int b0 = t * kTileBins;
    const int cpr = min(kTileBins, Bp - b0) / 8;  // chunks a row (Bp % 32 == 0)
    unsigned char* buf = s_p1 + (t & 1) * kP1Tile;
    const int c = tid & 15;  // two rows a pass, 16 chunks each
    if (c < cpr)
      for (int r = tid >> 4; r < rows; r += 2)
        cp_async16(buf + r * kP1Row + c * 16,
                   p1 + static_cast<size_t>(lane0 + r) * Bp + b0 + c * 8);
    // the tile's bit words go into the 16 bytes that pad the lane's row
    if (tid < rows)
      for (int w = 0; w < cpr / 4; ++w)
        cp_async4(buf + tid * kP1Row + kTileBins * 2 + w * 4,
                  bitw + static_cast<size_t>(lane0 + tid) * (Bp / 32) + b0 / 32 + w);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  int n_valid = 0;
  if (lane < L && tid < kRows) {
    n_valid = lens[lane];
    n_valid = n_valid < 0 ? 0 : (n_valid > Bp ? Bp : n_valid);
  }

  LaneState st{0u, 0xFFFFFFFFu, 0u};
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
    uint4* trow = reinterpret_cast<uint4*>(s_tok + tid * kOutRow);
    uint4* crow = reinterpret_cast<uint4*>(s_car + tid * kOutRow);
    for (int w = 0; tid < kRows && w < tw / 32; ++w) {
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(prow + kTileBins * 2 + w * 4);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int i = w * 32 + g * 8;  // bin inside the tile
        const uint4 pv = *reinterpret_cast<const uint4*>(prow + i * 2);
        const int n_live = n_valid - (b0 + i);
        if (n_live >= 8)
          code8<false>(st, pv, word >> (g * 8), 8, trow + i / 4, crow + i / 4);
        else
          code8<true>(st, pv, word >> (g * 8), n_live, trow + i / 4, crow + i / 4);
      }
    }
    __syncwarp();

    // the warp stores the tiles: one lane's row segment per pass, 16 bytes
    // a thread
    if (tid < tw / 4) {  // 16-byte chunks a row
      const size_t g = static_cast<size_t>(lane0) * Bp + b0 + tid * 4;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        *reinterpret_cast<uint4*>(tok + g + static_cast<size_t>(r) * Bp) =
            *reinterpret_cast<const uint4*>(s_tok + r * kOutRow + tid * 16);
        *reinterpret_cast<uint4*>(car + g + static_cast<size_t>(r) * Bp) =
            *reinterpret_cast<const uint4*>(s_car + r * kOutRow + tid * 16);
      }
    }
    __syncwarp();  // before the next tile overwrites the shared tiles
  }

  if (lane < L && tid < kRows) {
    // shortest-terminator flush from the frozen state: round low up to the
    // next 2^24 multiple, then two byte shifts
    const uint32_t low_r = (st.low + (kTop - 1)) & 0xFF000000u;
    fcar[lane] = static_cast<int32_t>(st.pend + (low_r < st.low ? 1u : 0u));
    ftok[lane] = static_cast<int32_t>((low_r >> 24) | (((low_r >> 16) & 0xFFu) << 8));
  }
}

}  // namespace

extern "C" int lane_encode_launch(const void* p1, const void* bitw,
                                  const void* lens, void* tok, void* car,
                                  void* ftok, void* fcar, int L, int Bp,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lane_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_encode_kernel<<<(L + kRows - 1) / kRows, 32, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(p1), static_cast<const uint32_t*>(bitw),
      static_cast<const int32_t*>(lens), static_cast<int32_t*>(tok),
      static_cast<int32_t*>(car), static_cast<int32_t*>(ftok),
      static_cast<int32_t*>(fcar), L, Bp);
  return static_cast<int>(cudaGetLastError());
}

// cudaGetErrorString for the codes every *_launch function returns
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
