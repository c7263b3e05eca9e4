// Est-on-device entropy stage for Hopper (sm_90a): the adaptive recode
// model and the range encoder, one serial trace per warp.
//
// Replaces avrecode_tpu/ops/pallas_coder.py::_kernel (the Pallas TPU kernel
// launched by _encode_raw).  Per valid bin: the estimator row at `slot`,
// the 6-input per-class mixer, squash, the APM stage keyed on (class,
// 2-bit history, stretch bucket), requantisation, the mixer update on the
// pre-APM error, the dual-rate counters with per-slot halving limits, and
// the range coder with raw (byte, carry) tokens; then the final flush.
// Same outputs as the plain version, est_coder.est_encode_plain, bit for
// bit:
//
//   slots, bits, pcabs, valid  int32 [S, T]   bins; valid != 1 skips a bin
//   limits, cls                int32 [S, NS]  per-slot halving limit, class
//   tbl                        int32 [4096, 2] stretch, squash
//   apm_row                    int32 [33]     identity APM row
//   pf_tab                     int32 [1024]   stretch of the fast counters'
//                                             probability, by f0 | f1 << 5
//                                             (est_coder.fast_stretch_table)
//   tok, car                   int32 [S, 2T+2] compacted tokens + flush pair
//                                              (zeroed by the caller)
//   count                      int32 [S]      tokens written, flush included
//   rows_scratch               uint64 [S, NS] estimator rows, only when the
//                                             launch plan keeps them out of
//                                             shared memory (else unused)
//
// Bounds on this card.  Bytes: every input read once and every token
// written once is 16 B a padded bin plus 8 B a slot (487 MB at S = 1,024,
// T = 28,346: 0.15 ms at 3.35 TB/s), and the ~150 integer operations a bin
// are less still.  Neither is what the kernel can reach: the container
// format gives every trace ONE range-coder stream and ONE adaptive model,
// so a trace is a serial chain, and the floor is the longest trace's bin
// count times the latency of one bin's dependent instructions.
//
// What the design does about the chain:
//   * One warp per trace.  All 32 threads run the chain redundantly on
//     warp-uniform values (a warp runs an instruction once whatever its
//     active threads, and same-address shared accesses broadcast), so no
//     value has to be handed from a leader thread to the others, and no
//     two traces share a warp: a trace never waits on another trace's
//     gathers as it did with 32 traces a warp.
//   * Per 32-bin tile, a parallel phase: four coalesced 128-byte loads
//     (slots, bits, pcabs, valid), started two tiles ahead; the dependent
//     gathers cls[slot] and limits[slot], started one tile ahead; the valid
//     bins compacted with __ballot_sync/__popc (holes are skipped, never a
//     stop); and per bin what does not depend on the model state
//     (stretch(pcab), the class, the halving limit) written as one 16-byte
//     entry into a shared-memory tile.  Then a serial phase over the
//     tile's valid entries.
//   * State close: mixer weights (79 x 8 int32), APM cells (395 x 33, as
//     uint16: a cell stays inside [0, 65535]) and the stretch/squash tables
//     (int16/uint16) live in shared memory.  An estimator row is packed
//     into 8 bytes (counters <= 0x7FFF in 15 bits each, fast counters
//     <= 0x18 in 5 bits each, the two last-bit fields in 2 bits each, and
//     the 12-bit stretch of the counters' probability, cached) and the rows
//     live in shared memory where the block's 227 KB hold them, in global
//     scratch otherwise (est_coder.est_launch_plan decides; the kernel is
//     right for any NS).  The whole warp initialises the state, coalesced.
//   * The two divisions off the chain, exactly: stretch(pf) comes from a
//     table by (f0, f1); stretch(pe) is computed with the same integer
//     division as before, but when the row is UPDATED, and cached in the
//     row, so the next reader finds it ready (only a bin that reads the
//     slot the bin before it wrote waits for it).
//   * Software pipelining inside the serial phase: the next bin's entry,
//     row and weights are loaded before this bin's are stored and
//     forwarded by a select when slot or class repeat; the coder step of
//     bin j runs in iteration j + 1, so the APM lookups and the two table
//     lookups behind p1 overlap the next bin's mixer.
//
// What is left is the bin itself: about 250 instructions and seven
// dependent shared-memory lookups (~29 cycles each on this card), 0.30 us a
// bin for a trace alone.  Tried, as variants run by chip_variants.py on an
// NVIDIA H100 80GB HBM3 at 700 W, against 0.298 us a bin: a third pipeline
// stage (the APM stage one bin behind the mixer, the coder two behind),
// 0.332; the counters and the division first in the iteration, 0.338; the
// table lookups as asm loads that the compiler may move across the state's
// stores, 0.298; the serial phase on 1 or 16 threads of the warp, 0.328 and
// 0.330 (an instruction costs a warp the same whatever its active
// threads).
//
// An SM holds as many traces as its shared memory (45 KB a trace at NS =
// 2,108): the kernel's time is flat up to 528 traces at that NS and grows
// with the number of waves beyond.
//
// Signed arithmetic stays in int: (w >> 6), (err * x) >> 14 and the APM
// update shift negative values and must be arithmetic shifts.  The mixer
// dot stays inside int32 (|sum| <= 2^18 * 6602 ~ 1.73e9) because >> 6
// comes before the multiply.  The coder's low/rng are uint32_t, where the
// mod-2^32 wrap and unsigned compares are native.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kNCls = 79;       // models/trace.py::N_CLS (checked by the wrapper)
constexpr int kApmHist = 5;     // history contexts {00, 01, 10, 11, none}
constexpr int kApmCells = 33;   // APM buckets per (class, history)
constexpr int kHalveFast = 0x18;
constexpr int kWClip = 1 << 24;
constexpr int kTbl = 4096;
constexpr int kPfTab = 1024;    // f0 | f1 << 5
constexpr int kMaxWarps = 8;

// shared-memory layout, in bytes (est_coder.py holds the same numbers and
// the launcher checks the size it is given against them)
constexpr int kTableBytes = kTbl * 2 + kTbl * 2 + kPfTab * 2;  // 18,432
constexpr int kTileBytes = 32 * 16;                            // entries
constexpr int kWtsBytes = kNCls * 8 * 4;                       // 2,528
constexpr int kApmBytes = (kNCls * kApmHist * kApmCells * 2 + 15) / 16 * 16;
constexpr int kWarpFixedBytes = kTileBytes + kWtsBytes + kApmBytes;  // 29,120

__host__ __device__ constexpr int rows_bytes(int NS) { return (NS * 8 + 15) / 16 * 16; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Estimator row, 8 bytes:
//   x: e0 [0,15)  e1 [15,30)  last bit [30,32) (2 = none yet)
//   y: f0 [0,5)   f1 [5,10)   second-last bit [10,12)
//      stretch(pe >> 4) [12,24), two's complement
__device__ __forceinline__ uint2 pack_row(int e0, int e1, int f0, int f1,
                                          int lb, int lb2,
                                          const int16_t* s_stretch) {
  // e0 <= 0x7FFF here, so the quotient of the unsigned division is the
  // signed one's
  const int pe = clampi(static_cast<int>((static_cast<uint32_t>(e0) << 16) /
                                         static_cast<uint32_t>(e0 + e1)),
                        1, 0xFFFF);
  const int x0 = s_stretch[pe >> 4];
  uint2 r;
  r.x = static_cast<uint32_t>(e0) | (static_cast<uint32_t>(e1) << 15) |
        (static_cast<uint32_t>(lb) << 30);
  r.y = static_cast<uint32_t>(f0) | (static_cast<uint32_t>(f1) << 5) |
        (static_cast<uint32_t>(lb2) << 10) |
        ((static_cast<uint32_t>(x0) & 0xFFFu) << 12);
  return r;
}

struct Coder {
  uint32_t low, rng;
  int pend, pos;
};

// range coder: put, then up to two renorm byte shifts.  With active false
// nothing changes (the first iteration of a trace holds no bin yet); the
// step is written with selects so that it stays inside the caller's basic
// block and the compiler can interleave it with the next bin's mixer.
__device__ __forceinline__ void coder_put(Coder& cd, bool active, int bit,
                                          int p1, int32_t* to, int32_t* co,
                                          bool writer) {
  const uint32_t r1 = (cd.rng >> 16) * static_cast<uint32_t>(p1);
  const uint32_t low_a = cd.low + r1;
  const bool zero = active && bit != 1;
  const bool one = active && bit == 1;
  cd.pend += (zero && low_a < cd.low) ? 1 : 0;  // carry out of the 32-bit low
  cd.low = zero ? low_a : cd.low;
  cd.rng = zero ? cd.rng - r1 : (one ? r1 : cd.rng);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool fire = active && cd.rng < kTop;
    if (fire && writer) {
      to[cd.pos] = static_cast<int32_t>(cd.low >> 24);
      co[cd.pos] = cd.pend;
    }
    cd.pos += fire ? 1 : 0;
    cd.pend = fire ? 0 : cd.pend;
    cd.low = fire ? cd.low << 8 : cd.low;
    cd.rng = fire ? cd.rng << 8 : cd.rng;
  }
}

template <bool kRowsShared>
__global__ void __launch_bounds__(kMaxWarps * 32)
est_encode_kernel(const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ bits,
                  const int32_t* __restrict__ pcabs,
                  const int32_t* __restrict__ valid,
                  const int32_t* __restrict__ limits,
                  const int32_t* __restrict__ cls,
                  const int32_t* __restrict__ tbl,
                  const int32_t* __restrict__ apm_row,
                  const int32_t* __restrict__ pf_tab,
                  int32_t* __restrict__ tok, int32_t* __restrict__ car,
                  int32_t* __restrict__ count, uint2* rows_scratch,
                  int S, int T, int NS) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_stretch = reinterpret_cast<int16_t*>(smem);
  uint16_t* s_squash = reinterpret_cast<uint16_t*>(smem + kTbl * 2);
  int16_t* s_pf = reinterpret_cast<int16_t*>(smem + kTbl * 4);
  for (int k = threadIdx.x; k < kTbl; k += blockDim.x) {
    s_stretch[k] = static_cast<int16_t>(tbl[2 * k]);
    s_squash[k] = static_cast<uint16_t>(tbl[2 * k + 1]);
  }
  for (int k = threadIdx.x; k < kPfTab; k += blockDim.x)
    s_pf[k] = static_cast<int16_t>(pf_tab[k]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // callers sort traces by length, shortest first: walk them from the
  // back, so that the longest chains start first and the tail is short
  const int s = S - 1 - (blockIdx.x * nwarps + warp);
  if (s < 0) return;

  const int warp_bytes = kWarpFixedBytes + (kRowsShared ? rows_bytes(NS) : 0);
  unsigned char* wbase = smem + kTableBytes + warp * warp_bytes;
  uint4* s_tile = reinterpret_cast<uint4*>(wbase);
  int4* s_wts = reinterpret_cast<int4*>(wbase + kTileBytes);
  uint16_t* s_apm = reinterpret_cast<uint16_t*>(wbase + kTileBytes + kWtsBytes);
  uint2* rows = kRowsShared
      ? reinterpret_cast<uint2*>(wbase + kWarpFixedBytes)
      : rows_scratch + static_cast<size_t>(s) * NS;

  // this trace's state, initialised by the whole warp as the host model's
  // pools are
  const uint2 row0 = pack_row(1, 1, 1, 1, 2, 2, s_stretch);  // no last bit yet
  for (int k = lane; k < NS; k += 32) rows[k] = row0;
  for (int k = lane; k < kNCls * 2; k += 32)
    s_wts[k] = (k & 1) ? make_int4(0, 0, 0, 0) : make_int4(24576, 24576, 0, 0);
  const uint16_t cell = static_cast<uint16_t>(apm_row[lane]);
  const uint16_t cell32 = static_cast<uint16_t>(apm_row[kApmCells - 1]);
  for (int r = 0; r < kNCls * kApmHist; ++r) {
    // 33 cells a row: thread 0 writes the last one too
    s_apm[r * kApmCells + lane] = cell;
    if (lane == 0) s_apm[r * kApmCells + kApmCells - 1] = cell32;
  }
  __syncwarp();

  const size_t row = static_cast<size_t>(s) * T;
  const int32_t* lim = limits + static_cast<size_t>(s) * NS;
  const int32_t* cl = cls + static_cast<size_t>(s) * NS;
  int32_t* to = tok + static_cast<size_t>(s) * (2 * static_cast<size_t>(T) + 2);
  int32_t* co = car + static_cast<size_t>(s) * (2 * static_cast<size_t>(T) + 2);
  const bool writer = lane == 0;

  Coder cd{0u, 0xFFFFFFFFu, 0, 0};
  int held_bit = 0, held_p1 = 0;
  bool held = false;  // a bin whose coder step has not run yet

  // tile pipeline, per thread: a = tile t + 2 (raw loads in flight),
  // b = tile t + 1 (raw loads landed, gathers in flight), c = tile t
  const int nt = (T + 31) / 32;
  int a_slot = 0, a_bit = 0, a_pcab = 0, a_valid = 0;
  int b_slot = 0, b_bit = 0, b_pcab = 0, b_valid = 0, b_cls = 0, b_lim = 0;

  auto load_raw = [&](int t) {
    const int i = t * 32 + lane;
    a_valid = 0;
    a_slot = a_bit = a_pcab = 0;
    if (t < nt && i < T) {
      a_slot = slots[row + i];
      a_bit = bits[row + i];
      a_pcab = pcabs[row + i];
      a_valid = valid[row + i];
    }
  };
  auto gather = [&]() {  // a -> b, and start b's dependent loads
    b_slot = a_slot;
    b_bit = a_bit;
    b_pcab = a_pcab;
    b_valid = a_valid;
    b_cls = b_lim = 0;
    if (b_valid == 1) {
      b_cls = cl[b_slot];
      b_lim = lim[b_slot];
      if (!kRowsShared)  // bring the row's line toward L1 before the chain
        asm volatile("prefetch.global.L1 [%0];" ::"l"(rows + b_slot));
    }
  };

  load_raw(0);
  gather();
  load_raw(1);
  for (int t = 0; t < nt; ++t) {
    const int c_slot = b_slot, c_bit = b_bit, c_pcab = b_pcab;
    const int c_valid = b_valid, c_cls = b_cls, c_lim = b_lim;
    gather();
    load_raw(t + 2);

    // parallel phase: compact the valid bins, one entry a bin
    const unsigned live = __ballot_sync(0xFFFFFFFFu, c_valid == 1);
    const int n = __popc(live);
    if (c_valid == 1) {
      const int x1 = c_pcab > 0 ? s_stretch[c_pcab >> 4] : 0;
      s_tile[__popc(live & ((1u << lane) - 1u))] = make_uint4(
          static_cast<uint32_t>(c_slot),
          static_cast<uint32_t>(c_lim) | (static_cast<uint32_t>(c_cls) << 16) |
              (static_cast<uint32_t>(c_bit) << 24),
          static_cast<uint32_t>(x1), 0u);
    }
    __syncwarp();

    // serial phase, every thread on the same values
    if (n > 0) {
      uint4 en = s_tile[0];
      uint2 rw = rows[en.x];
      int4 wa = s_wts[((en.y >> 16) & 0xFF) * 2];
      int4 wb = s_wts[((en.y >> 16) & 0xFF) * 2 + 1];
      for (int j = 0; j < n; ++j) {
        const int slot = static_cast<int>(en.x);
        const int limit = static_cast<int>(en.y & 0xFFFFu);
        const int c = static_cast<int>((en.y >> 16) & 0xFFu);
        const int bit = static_cast<int>(en.y >> 24);
        const int x1 = static_cast<int>(en.z);

        // the next bin's entry, row and weights, loaded before this bin's
        // are stored (forwarded below when slot or class repeat)
        const int jn = j + 1 < n ? j + 1 : j;
        const uint4 en_n = s_tile[jn];
        uint2 rw_n = rows[en_n.x];
        const int c_n = static_cast<int>((en_n.y >> 16) & 0xFFu);
        int4 wa_n = s_wts[c_n * 2];
        int4 wb_n = s_wts[c_n * 2 + 1];

        // the held bin's coder step: its p1 came out of the last iteration
        coder_put(cd, held, held_bit, held_p1, to, co, writer);

        const int e0 = rw.x & 0x7FFF, e1 = (rw.x >> 15) & 0x7FFF;
        const int lb = rw.x >> 30;
        const int f0 = rw.y & 31, f1 = (rw.y >> 5) & 31;
        const int lb2 = (rw.y >> 10) & 3;
        // mixer inputs: counter probability (cached stretch), CABAC
        // probability, bias, fast counter, last two bits of this slot
        const int x0 = (static_cast<int>(rw.y) << 8) >> 20;
        const int x3 = s_pf[rw.y & 0x3FF];
        const int x4 = lb == 2 ? 0 : (lb == 1 ? 256 : -256);
        const int x5 = lb2 == 2 ? 0 : (lb2 == 1 ? 128 : -128);
        const int w0 = wa.x, w1 = wa.y, w2 = wa.z, w3 = wa.w, w4 = wb.x, w5 = wb.y;
        int dot = ((w0 >> 6) * x0 + (w1 >> 6) * x1 + (w2 >> 6) * 77 +
                   (w3 >> 6) * x3 + (w4 >> 6) * x4 + (w5 >> 6) * x5) >> 10;
        dot = clampi(dot, -2048, 2047);
        const int pmix = s_squash[dot + 2048];

        // the mixer learns on its pre-APM output
        const int tgt = bit << 16;
        const int err = tgt - pmix;
        int4 na, nb;
        na.x = clampi(w0 + ((err * x0) >> 14), -kWClip, kWClip);
        na.y = clampi(w1 + ((err * x1) >> 14), -kWClip, kWClip);
        na.z = clampi(w2 + ((err * 77) >> 14), -kWClip, kWClip);
        na.w = clampi(w3 + ((err * x3) >> 14), -kWClip, kWClip);
        nb.x = clampi(w4 + ((err * x4) >> 14), -kWClip, kWClip);
        nb.y = clampi(w5 + ((err * x5) >> 14), -kWClip, kWClip);
        nb.z = nb.w = 0;
        s_wts[c * 2] = na;
        s_wts[c * 2 + 1] = nb;

        // dual-rate counters with the slot's own halving limit
        int e0n = e0 + bit, e1n = e1 + (1 - bit);
        int f0n = f0 + bit, f1n = f1 + (1 - bit);
        if (e0n + e1n > limit) {
          e0n = (e0n + 1) >> 1;
          e1n = (e1n + 1) >> 1;
        }
        if (f0n + f1n > kHalveFast) {
          f0n = (f0n + 1) >> 1;
          f1n = (f1n + 1) >> 1;
        }
        const uint2 rw_new = pack_row(e0n, e1n, f0n, f1n, bit, lb, s_stretch);
        rows[slot] = rw_new;

        // APM: interpolate between two cells of the (class, history) row
        const int u = s_stretch[pmix >> 4] + 2048;
        const int aj = u >> 7;
        const int frac = u - (aj << 7);
        const int h = (lb == 2 || lb2 == 2) ? 4 : lb * 2 + lb2;
        uint16_t* ar = s_apm + (c * kApmHist + h) * kApmCells + aj;
        const int a0 = ar[0], a1 = ar[1];
        const int pa = (a0 * (128 - frac) + a1 * frac) >> 7;
        const int pb = clampi((pmix + pa) >> 1, 1, 65535);
        ar[0] = static_cast<uint16_t>(a0 + (((tgt - a0) * (128 - frac)) >> 13));
        ar[1] = static_cast<uint16_t>(a1 + (((tgt - a1) * frac) >> 13));  // >> (7 + kApmRate)
        held_p1 = s_squash[s_stretch[pb >> 4] + 2048];
        held_bit = bit;
        held = true;

        // hand over to the next bin
        if (j + 1 < n && static_cast<int>(en_n.x) == slot) rw_n = rw_new;
        if (j + 1 < n && c_n == c) {
          wa_n = na;
          wb_n = nb;
        }
        en = en_n;
        rw = rw_n;
        wa = wa_n;
        wb = wb_n;
      }
    }
    __syncwarp();  // the next tile's entries overwrite this one's
  }
  coder_put(cd, held, held_bit, held_p1, to, co, writer);

  // shortest-terminator flush: round low up to the next 2^24 multiple,
  // fold its carry into pend, emit the revealed byte and the flush event
  if (writer) {
    const uint32_t low_r = (cd.low + (kTop - 1)) & 0xFF000000u;
    to[cd.pos] = static_cast<int32_t>(low_r >> 24);
    co[cd.pos] = cd.pend + (low_r < cd.low ? 1 : 0);
    to[cd.pos + 1] = static_cast<int32_t>((low_r >> 16) & 0xFFu);
    co[cd.pos + 1] = 0;
    count[s] = cd.pos + 2;
  }
}

template <bool kRowsShared>
cudaError_t launch(const void* slots, const void* bits, const void* pcabs,
                   const void* valid, const void* limits, const void* cls,
                   const void* tbl, const void* apm_row, const void* pf_tab,
                   void* tok, void* car, void* count, void* rows_scratch,
                   int S, int T, int NS, int warps, int smem,
                   cudaStream_t stream) {
  auto kernel = est_encode_kernel<kRowsShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(S + warps - 1) / warps, warps * 32, smem, stream>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(bits),
      static_cast<const int32_t*>(pcabs), static_cast<const int32_t*>(valid),
      static_cast<const int32_t*>(limits), static_cast<const int32_t*>(cls),
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(apm_row),
      static_cast<const int32_t*>(pf_tab), static_cast<int32_t*>(tok),
      static_cast<int32_t*>(car), static_cast<int32_t*>(count),
      static_cast<uint2*>(rows_scratch), S, T, NS);
  return cudaGetLastError();
}

}  // namespace

// warps: traces a block; rows_shared: estimator rows in shared memory (1) or
// in rows_scratch (0); smem: the block's dynamic shared memory in bytes, as
// est_coder.est_launch_plan computed it (checked here against the kernel's
// own layout)
extern "C" int est_encode_launch(const void* slots, const void* bits,
                                 const void* pcabs, const void* valid,
                                 const void* limits, const void* cls,
                                 const void* tbl, const void* apm_row,
                                 const void* pf_tab, void* tok, void* car,
                                 void* count, void* rows_scratch, int S, int T,
                                 int NS, int warps, int rows_shared, int smem,
                                 void* stream) {
  if (warps < 1 || warps > kMaxWarps ||
      smem != kTableBytes +
                  warps * (kWarpFixedBytes + (rows_shared ? rows_bytes(NS) : 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rows_shared
          ? launch<true>(slots, bits, pcabs, valid, limits, cls, tbl, apm_row,
                         pf_tab, tok, car, count, rows_scratch, S, T, NS, warps,
                         smem, st)
          : launch<false>(slots, bits, pcabs, valid, limits, cls, tbl, apm_row,
                          pf_tab, tok, car, count, rows_scratch, S, T, NS, warps,
                          smem, st);
  return static_cast<int>(err);
}
