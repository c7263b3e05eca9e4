// Est-on-device entropy stage for Hopper (sm_90a): the adaptive recode
// model and the range encoder, one serial trace per block of stage warps.
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
//   waits                      int32 [S, 4]   or null: per trace and stage,
//                                             the ring tiles on which the
//                                             stage found its ring not ready
//                                             (below)
//
// Bounds on this card.  Bytes: every input read once and every token
// written once is 16 B a padded bin plus 8 B a slot (487 MB at S = 1,024,
// T = 28,346: 0.15 ms at 3.35 TB/s), and the ~150 integer operations a bin
// are less still.  Neither is what the kernel can reach: the container
// format gives every trace ONE range-coder stream and ONE adaptive model,
// so a trace is a serial chain, and the floor is the longest trace's bin
// count times the latency of one bin's dependent instructions: 125 cycles,
// the mixer weights' loop-carried path (chip_latency.cu, est_chain; the
// estimator row's 58, the coder's 53, an APM cell's 48).
//
// What the design does about the chain:
//   * Stage warps.  The container is already encoded, so every bin's bit
//     is an input and no value flows backward through the model: a bin's
//     work is a feed-forward chain of four stages, each with only its own
//     state, and a trace gets one warp a stage:
//       rows   the tile loads and the compaction (below), then per bin the
//              estimator row at `slot`, read and updated (the dual-rate
//              counters, the last two bits); state: the rows
//       mixer  the dot over the class's 6 weights, squash, the weight
//              update on err = bit << 16 - pmix; state: the weights
//       APM    stretch(pmix), the interpolation in the (class, h) row, the
//              cell update, p1 = squash(stretch(pb)); state: the APM cells
//       coder  the range-coder step on (bit, p1) and the token writes;
//              state: low, rng, pend, pos
//     The warps of a block land on the SM's four schedulers (warp index
//     mod 4), so a bin costs the busiest stage's instructions, not the sum
//     of all four on one scheduler.  A trace's warps are rotated by its
//     place in the block, so that with several traces a block every
//     scheduler holds one warp of each stage.
//   * What depends on no state runs a bin a thread, not on the serial
//     path.  Per 32-bin load tile, the rows warp's parallel phases: before
//     its serial loop, four coalesced 128-byte loads (slots, bits, pcabs,
//     valid), started two tiles ahead; the dependent gathers cls[slot] and
//     limits[slot], started one tile ahead; the valid bins compacted with
//     __ballot_sync/__popc (holes are skipped, never a stop), and per bin
//     stretch(pcab), the class and the halving limit written as one 16-byte
//     entry into a shared-memory tile.  After it, the mixer's inputs from
//     each bin's row as read: x0 = stretch of the counters' probability
//     (its integer division included), x3 = stretch of the fast counters'
//     (a table by (f0, f1)), x4 and x5 from the last two bits, and the APM
//     row (class, history); the serial loop itself only reads, updates and
//     stores the rows.
//   * Hand-over: between two stages a ring of kRing tiles in shared
//     memory, a tile the compacted valid bins of one 32-bin load tile and
//     their count, with a full and an empty mbarrier a tile (count 32: the
//     whole warp arrives, each thread releasing its own stores).  Per bin
//     rows -> mixer carries x0, x1, x3, x4, x5, the class, the APM row and
//     the bit (32 B); mixer -> APM pmix, the APM row and the bit (4 B);
//     APM -> coder p1 and the bit (4 B).  A tile of count -1 ends the
//     trace.  A stage that finds a tile not ready counts it (waits: the
//     rows warp a full rows -> mixer ring, the others an empty input
//     ring), which says which stage sets the pace.
//   * Inside a stage, the serial idiom: all 32 threads run the stage's
//     loop on warp-uniform values (a warp issues an instruction once
//     whatever its active threads, and same-address shared accesses
//     broadcast), and each stage loads the next bin's state before it
//     stores this bin's, forwarded by a select when the slot (rows) or the
//     class (mixer) repeats.
//   * State close: mixer weights (79 x 8 int32), APM cells (395 x 33, as
//     uint16: a cell stays inside [0, 65535]) and the stretch/squash tables
//     (int16/uint16) live in shared memory.  An estimator row is packed
//     into 8 bytes (counters <= 0x7FFF in 15 bits each, fast counters
//     <= 0x18 in 5 bits each, the two last-bit fields in 2 bits each) and
//     the rows live in shared memory where the block's 227 KB hold them,
//     in global scratch otherwise (est_coder.est_launch_plan decides; the
//     kernel is right for any NS).  Each stage warp initialises its own
//     state.
//
// Tried before the stage warps, with the whole bin on one warp (about 250
// instructions and seven dependent shared-memory lookups, 0.298 us a bin
// for a trace alone, ~590 cycles against an issue floor of ~500), as
// variants run by chip_variants.py on an NVIDIA H100 80GB HBM3 at 700 W: a
// third pipeline stage (the APM stage one bin behind the mixer, the coder
// two behind), 0.332 us; the counters and the division first in the
// iteration, 0.338; the table lookups as asm loads that the compiler may
// move across the state's stores, 0.298; the serial phase on 1 or 16
// threads of the warp, 0.328 and 0.330 (an instruction costs a warp the
// same whatever its active threads).  None got under ~500 cycles, because
// every instruction of the bin issued from one scheduler.  The first stage
// warps (the division, the fast-counter lookup and the mixer's other
// inputs in the rows warp's serial loop) ran 0.155 us a bin: the rows warp
// set the pace, the three others finding their input ring empty on every
// tile.  With those inputs a bin a thread, 0.087 us (~173 cycles): the
// mixer sets the pace (83 instructions a bin, against its 125-cycle
// chain), the rows warp finding its ring full on nearly every tile.  The
// mixer's clamps as DPX instructions (__viaddmax_s32, __viaddmin_s32_relu;
// 67 instructions a bin, the loop unrolled by two) ran 0.085 us, 3.5% less
// on a lone trace and 0.8% more on 128 traces; not kept.
//
// An SM holds as many traces as its shared memory (~50 KB a trace at NS =
// 2,108, four an SM), and registers stay at 64 a thread or under
// (__launch_bounds__ of 8 traces' 32 warps), so that they never bind first.
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
constexpr int kStages = 4;      // warps a trace: rows, mixer, APM, coder
constexpr int kRing = 4;        // tiles a ring
constexpr int kMaxTraces = 8;   // traces a block: 32 warps

// shared-memory layout, in bytes (est_coder.py holds the same numbers and
// the launcher checks the size it is given against them): the tables, then
// per trace its fixed state and rings, then its rows where they are shared
constexpr int kTableBytes = kTbl * 2 + kTbl * 2 + kPfTab * 2;  // 18,432
constexpr int kTileBytes = 32 * 16;                            // entries
constexpr int kWtsBytes = kNCls * 8 * 4;                       // 2,528
constexpr int kApmBytes = (kNCls * kApmHist * kApmCells * 2 + 15) / 16 * 16;
constexpr int kRmBytes = kRing * 32 * 32;  // rows -> mixer, two int4 a bin
constexpr int kMaBytes = kRing * 32 * 4;   // mixer -> APM
constexpr int kAcBytes = kRing * 32 * 4;   // APM -> coder
constexpr int kCountBytes = 3 * kRing * 4;      // a tile's bins, a ring
constexpr int kBarBytes = 3 * kRing * 2 * 8;    // full, empty a tile, a ring
constexpr int kTraceFixedBytes = kTileBytes + kWtsBytes + kApmBytes + kRmBytes +
                                 kMaBytes + kAcBytes + kCountBytes +
                                 kBarBytes;  // 34,480

__host__ __device__ constexpr int rows_bytes(int NS) { return (NS * 8 + 15) / 16 * 16; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// the phase of parity `parity` of the barrier has completed (acquire):
// test_wait returns at once, try_wait may suspend the warp for a while
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase; a wait that does not pass at once adds one to waits
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity,
                                          int& waits) {
  if (!mbar_test(bar, parity)) {
    ++waits;
    while (!mbar_try(bar, parity)) {
    }
  }
}

// A ring between two stage warps: kRing tiles of 32 bins, the bins a tile
// (-1: the trace ended), and a full and an empty barrier a tile.  Tile u
// of a trace lies at u % kRing; its use k = u / kRing completes phase k of
// both barriers, of parity k & 1.  Every ring carries the same tiles, so a
// stage keeps one position for its input and its output ring.
struct Ring {
  unsigned char* data;
  int* count;
  uint64_t* full;
  uint64_t* empty;
};

struct Pos {
  int slot = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void next() {
    if (++slot == kRing) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// Estimator row, 8 bytes:
//   x: e0 [0,15)  e1 [15,30)  last bit [30,32) (2 = none yet)
//   y: f0 [0,5)   f1 [5,10)   second-last bit [10,12)
__device__ __forceinline__ uint2 pack_row(int e0, int e1, int f0, int f1,
                                          int lb, int lb2) {
  uint2 r;
  r.x = static_cast<uint32_t>(e0) | (static_cast<uint32_t>(e1) << 15) |
        (static_cast<uint32_t>(lb) << 30);
  r.y = static_cast<uint32_t>(f0) | (static_cast<uint32_t>(f1) << 5) |
        (static_cast<uint32_t>(lb2) << 10);
  return r;
}

// stretch of the counters' probability: e0 <= 0x7FFF here, so the
// quotient of the unsigned division is the signed one's
__device__ __forceinline__ int counter_stretch(int e0, int e1,
                                               const int16_t* s_stretch) {
  const int pe = clampi(static_cast<int>((static_cast<uint32_t>(e0) << 16) /
                                         static_cast<uint32_t>(e0 + e1)),
                        1, 0xFFFF);
  return s_stretch[pe >> 4];
}

struct Coder {
  uint32_t low, rng;
  int pend, pos;
};

// range coder: put, then up to two renorm byte shifts
__device__ __forceinline__ void coder_put(Coder& cd, int bit, int p1,
                                          int32_t* to, int32_t* co,
                                          bool writer) {
  const uint32_t r1 = (cd.rng >> 16) * static_cast<uint32_t>(p1);
  const uint32_t low_a = cd.low + r1;
  const bool zero = bit != 1;
  cd.pend += (zero && low_a < cd.low) ? 1 : 0;  // carry out of the 32-bit low
  cd.low = zero ? low_a : cd.low;
  cd.rng = zero ? cd.rng - r1 : r1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool fire = cd.rng < kTop;
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

// The rows stage, with the tile loads: every valid bin's estimator row ->
// the mixer's inputs on ring `out`.
template <bool kRowsShared>
__device__ __forceinline__ void rows_stage(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ bits,
    const int32_t* __restrict__ pcabs, const int32_t* __restrict__ valid,
    const int32_t* lim, const int32_t* cl, const int16_t* s_stretch,
    const int16_t* s_pf, uint4* s_tile, uint2* rows, Ring out, size_t row,
    int T, int NS, int lane, int& waits) {
  // this trace's rows, initialised as the host model's pool is
  const uint2 row0 = pack_row(1, 1, 1, 1, 2, 2);  // no last bit yet
  for (int k = lane; k < NS; k += 32) rows[k] = row0;
  __syncwarp();

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

  Pos pos;
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

    if (n > 0) {
      mbar_wait(out.empty + pos.slot, pos.parity ^ 1u, waits);
      int4* oa = reinterpret_cast<int4*>(out.data) + pos.slot * 64;

      // serial phase, every thread on the same values: each bin's row as
      // read goes to its ring entry, its update to the rows
      uint4 en = s_tile[0];
      uint2 rw = rows[en.x];
      for (int j = 0; j < n; ++j) {
        const int slot = static_cast<int>(en.x);
        const int limit = static_cast<int>(en.y & 0xFFFFu);
        const int bit = static_cast<int>(en.y >> 24);

        // the next bin's entry and row, loaded before this bin's row is
        // stored (forwarded below when the slot repeats; the last bin
        // forwards to nothing)
        const uint4 en_n = s_tile[j + 1 < n ? j + 1 : j];
        uint2 rw_n = rows[en_n.x];
        *reinterpret_cast<uint2*>(oa + j) = rw;

        // dual-rate counters with the slot's own halving limit
        int e0n = (rw.x & 0x7FFF) + bit, e1n = ((rw.x >> 15) & 0x7FFF) + (1 - bit);
        int f0n = (rw.y & 31) + bit, f1n = ((rw.y >> 5) & 31) + (1 - bit);
        if (e0n + e1n > limit) {
          e0n = (e0n + 1) >> 1;
          e1n = (e1n + 1) >> 1;
        }
        if (f0n + f1n > kHalveFast) {
          f0n = (f0n + 1) >> 1;
          f1n = (f1n + 1) >> 1;
        }
        const uint2 rw_new =
            pack_row(e0n, e1n, f0n, f1n, bit, static_cast<int>(rw.x >> 30));
        rows[slot] = rw_new;

        if (static_cast<int>(en_n.x) == slot) rw_n = rw_new;
        en = en_n;
        rw = rw_n;
      }
      __syncwarp();  // every thread's copy of the rows is in the ring

      // parallel phase, a bin a thread: the mixer's inputs from the row as
      // read (counter probability, CABAC probability, fast counter, last
      // two bits of this slot), the APM row (class, history) and the bit
      if (lane < n) {
        const uint2 r = *reinterpret_cast<const uint2*>(oa + lane);
        const uint4 e = s_tile[lane];
        const int lb = r.x >> 30, lb2 = (r.y >> 10) & 3;
        const int c = static_cast<int>((e.y >> 16) & 0xFFu);
        const int bit = static_cast<int>(e.y >> 24);
        const int h = (lb == 2 || lb2 == 2) ? 4 : lb * 2 + lb2;
        oa[lane] = make_int4(
            counter_stretch(r.x & 0x7FFF, (r.x >> 15) & 0x7FFF, s_stretch),
            static_cast<int>(e.z), s_pf[r.y & 0x3FF],
            lb == 2 ? 0 : (lb == 1 ? 256 : -256));
        oa[32 + lane] = make_int4(
            lb2 == 2 ? 0 : (lb2 == 1 ? 128 : -128), c,
            static_cast<int>((static_cast<uint32_t>(c * kApmHist + h) << 16) |
                             (static_cast<uint32_t>(bit) << 31)),
            bit << 16);
      }
      out.count[pos.slot] = n;
      mbar_arrive(out.full + pos.slot);
      pos.next();
    }
    __syncwarp();  // the next tile's entries overwrite this one's
  }
  mbar_wait(out.empty + pos.slot, pos.parity ^ 1u, waits);
  out.count[pos.slot] = -1;
  mbar_arrive(out.full + pos.slot);
}

// The mixer stage: each bin's inputs -> pmix on ring `out`, the class's
// weights updated on the pre-APM error.
__device__ __forceinline__ void mixer_stage(const uint16_t* s_squash,
                                            int4* s_wts, Ring in, Ring out,
                                            int lane, int& waits) {
  for (int k = lane; k < kNCls * 2; k += 32)
    s_wts[k] = (k & 1) ? make_int4(0, 0, 0, 0) : make_int4(24576, 24576, 0, 0);
  __syncwarp();
  int unused = 0;
  for (Pos pos;; pos.next()) {
    mbar_wait(in.full + pos.slot, pos.parity, waits);
    const int n = in.count[pos.slot];
    mbar_wait(out.empty + pos.slot, pos.parity ^ 1u, unused);
    out.count[pos.slot] = n;
    if (n < 0) {
      mbar_arrive(out.full + pos.slot);
      return;
    }
    const int4* ia = reinterpret_cast<const int4*>(in.data) + pos.slot * 64;
    uint32_t* oe = reinterpret_cast<uint32_t*>(out.data) + pos.slot * 32;
    int4 A = ia[0], B = ia[32];
    int4 wa = s_wts[B.y * 2], wb = s_wts[B.y * 2 + 1];
    for (int j = 0; j < n; ++j) {
      const int x0 = A.x, x1 = A.y, x3 = A.z, x4 = A.w;
      const int x5 = B.x, c = B.y;

      // the next bin's inputs and weights, loaded before this bin's are
      // stored (forwarded below when the class repeats; the last bin
      // forwards to nothing)
      const int jn = j + 1 < n ? j + 1 : j;
      const int4 A_n = ia[jn], B_n = ia[32 + jn];
      const int c_n = B_n.y;
      int4 wa_n = s_wts[c_n * 2];
      int4 wb_n = s_wts[c_n * 2 + 1];

      const int w0 = wa.x, w1 = wa.y, w2 = wa.z, w3 = wa.w, w4 = wb.x, w5 = wb.y;
      int dot = ((w0 >> 6) * x0 + (w1 >> 6) * x1 + (w2 >> 6) * 77 +
                 (w3 >> 6) * x3 + (w4 >> 6) * x4 + (w5 >> 6) * x5) >> 10;
      dot = clampi(dot, -2048, 2047);
      const int pmix = s_squash[dot + 2048];
      oe[j] = static_cast<uint32_t>(pmix) | static_cast<uint32_t>(B.z);

      // the mixer learns on its pre-APM output
      const int err = B.w - pmix;
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

      if (c_n == c) {
        wa_n = na;
        wb_n = nb;
      }
      A = A_n;
      B = B_n;
      wa = wa_n;
      wb = wb_n;
    }
    mbar_arrive(in.empty + pos.slot);
    mbar_arrive(out.full + pos.slot);
  }
}

// The APM stage: pmix -> p1 on ring `out`, through the (class, history)
// row's two cells around stretch(pmix), which learn from the bit.
__device__ __forceinline__ void apm_stage(const int16_t* s_stretch,
                                          const uint16_t* s_squash,
                                          uint16_t* s_apm,
                                          const int32_t* apm_row, Ring in,
                                          Ring out, int lane, int& waits) {
  const uint16_t cell = static_cast<uint16_t>(apm_row[lane]);
  const uint16_t cell32 = static_cast<uint16_t>(apm_row[kApmCells - 1]);
  for (int r = 0; r < kNCls * kApmHist; ++r) {
    // 33 cells a row: thread 0 writes the last one too
    s_apm[r * kApmCells + lane] = cell;
    if (lane == 0) s_apm[r * kApmCells + kApmCells - 1] = cell32;
  }
  __syncwarp();
  int unused = 0;
  for (Pos pos;; pos.next()) {
    mbar_wait(in.full + pos.slot, pos.parity, waits);
    const int n = in.count[pos.slot];
    mbar_wait(out.empty + pos.slot, pos.parity ^ 1u, unused);
    out.count[pos.slot] = n;
    if (n < 0) {
      mbar_arrive(out.full + pos.slot);
      return;
    }
    const uint32_t* ie = reinterpret_cast<const uint32_t*>(in.data) + pos.slot * 32;
    uint32_t* oe = reinterpret_cast<uint32_t*>(out.data) + pos.slot * 32;
    uint32_t e = ie[0];
    int u = s_stretch[(e & 0xFFFFu) >> 4] + 2048;
    for (int j = 0; j < n; ++j) {
      const int pmix = static_cast<int>(e & 0xFFFFu);
      const int arow = static_cast<int>((e >> 16) & 0x7FFFu);
      const int bit = static_cast<int>(e >> 31);
      const int tgt = bit << 16;

      // the next bin's bucket, before this bin's cells are stored
      const int jn = j + 1 < n ? j + 1 : j;
      const uint32_t e_n = ie[jn];
      const int u_n = s_stretch[(e_n & 0xFFFFu) >> 4] + 2048;

      // interpolate between two cells of the (class, history) row
      const int aj = u >> 7;
      const int frac = u - (aj << 7);
      uint16_t* ar = s_apm + arow * kApmCells + aj;
      const int a0 = ar[0], a1 = ar[1];
      const int pa = (a0 * (128 - frac) + a1 * frac) >> 7;
      const int pb = clampi((pmix + pa) >> 1, 1, 65535);
      ar[0] = static_cast<uint16_t>(a0 + (((tgt - a0) * (128 - frac)) >> 13));
      ar[1] = static_cast<uint16_t>(a1 + (((tgt - a1) * frac) >> 13));  // >> (7 + kApmRate)
      const int p1 = s_squash[s_stretch[pb >> 4] + 2048];
      oe[j] = static_cast<uint32_t>(p1) | (static_cast<uint32_t>(bit) << 16);
      e = e_n;
      u = u_n;
    }
    mbar_arrive(in.empty + pos.slot);
    mbar_arrive(out.full + pos.slot);
  }
}

// The coder stage: (p1, bit) -> tokens, then the shortest-terminator flush.
__device__ __forceinline__ void coder_stage(Ring in, int32_t* to, int32_t* co,
                                            int32_t* count, int s, int lane,
                                            int& waits) {
  const bool writer = lane == 0;
  Coder cd{0u, 0xFFFFFFFFu, 0, 0};
  for (Pos pos;; pos.next()) {
    mbar_wait(in.full + pos.slot, pos.parity, waits);
    const int n = in.count[pos.slot];
    if (n < 0) break;
    const uint32_t* ie = reinterpret_cast<const uint32_t*>(in.data) + pos.slot * 32;
    for (int j = 0; j < n; ++j) {
      const uint32_t e = ie[j];
      coder_put(cd, static_cast<int>(e >> 16), static_cast<int>(e & 0xFFFFu),
                to, co, writer);
    }
    mbar_arrive(in.empty + pos.slot);
  }
  // round low up to the next 2^24 multiple, fold its carry into pend, emit
  // the revealed byte and the flush event
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
__global__ void __launch_bounds__(kMaxTraces * kStages * 32)
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
                  int32_t* __restrict__ waits, int S, int T, int NS) {
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

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int traces = blockDim.x / (32 * kStages);
  const int tb = warp / kStages;  // the trace's place in the block
  const int stage = (warp + tb) % kStages;
  const int trace_bytes = kTraceFixedBytes + (kRowsShared ? rows_bytes(NS) : 0);
  unsigned char* base = smem + kTableBytes + tb * trace_bytes;
  unsigned char* rings = base + kTileBytes + kWtsBytes + kApmBytes;
  int* counts = reinterpret_cast<int*>(rings + kRmBytes + kMaBytes + kAcBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      rings + kRmBytes + kMaBytes + kAcBytes + kCountBytes);
  if (warp % kStages == 0 && lane < 3 * kRing * 2) mbar_init(bars + lane, 32);
  __syncthreads();

  // callers sort traces by length, shortest first: walk them from the
  // back, so that the longest chains start first and the tail is short
  const int s = S - 1 - (blockIdx.x * traces + tb);
  if (s < 0) return;

  // ring r: its tiles, counts, full barriers, then empty barriers
  auto ring = [&](int r, unsigned char* data) {
    return Ring{data, counts + r * kRing, bars + r * 2 * kRing,
                bars + r * 2 * kRing + kRing};
  };
  const Ring rm = ring(0, rings);
  const Ring ma = ring(1, rings + kRmBytes);
  const Ring ac = ring(2, rings + kRmBytes + kMaBytes);

  int waited = 0;
  if (stage == 0) {
    uint2* rows = kRowsShared
        ? reinterpret_cast<uint2*>(base + kTraceFixedBytes)
        : rows_scratch + static_cast<size_t>(s) * NS;
    rows_stage<kRowsShared>(
        slots, bits, pcabs, valid, limits + static_cast<size_t>(s) * NS,
        cls + static_cast<size_t>(s) * NS, s_stretch, s_pf,
        reinterpret_cast<uint4*>(base), rows, rm, static_cast<size_t>(s) * T,
        T, NS, lane, waited);
  } else if (stage == 1) {
    mixer_stage(s_squash, reinterpret_cast<int4*>(base + kTileBytes), rm, ma,
                lane, waited);
  } else if (stage == 2) {
    apm_stage(s_stretch, s_squash,
              reinterpret_cast<uint16_t*>(base + kTileBytes + kWtsBytes),
              apm_row, ma, ac, lane, waited);
  } else {
    const size_t seg = static_cast<size_t>(s) * (2 * static_cast<size_t>(T) + 2);
    coder_stage(ac, tok + seg, car + seg, count, s, lane, waited);
  }
  if (waits != nullptr && lane == 0) waits[s * kStages + stage] = waited;
}

template <bool kRowsShared>
cudaError_t launch(const void* slots, const void* bits, const void* pcabs,
                   const void* valid, const void* limits, const void* cls,
                   const void* tbl, const void* apm_row, const void* pf_tab,
                   void* tok, void* car, void* count, void* rows_scratch,
                   void* waits, int S, int T, int NS, int traces, int smem,
                   cudaStream_t stream) {
  auto kernel = est_encode_kernel<kRowsShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(S + traces - 1) / traces, traces * kStages * 32, smem, stream>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(bits),
      static_cast<const int32_t*>(pcabs), static_cast<const int32_t*>(valid),
      static_cast<const int32_t*>(limits), static_cast<const int32_t*>(cls),
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(apm_row),
      static_cast<const int32_t*>(pf_tab), static_cast<int32_t*>(tok),
      static_cast<int32_t*>(car), static_cast<int32_t*>(count),
      static_cast<uint2*>(rows_scratch), static_cast<int32_t*>(waits), S, T,
      NS);
  return cudaGetLastError();
}

}  // namespace

// traces: traces a block (kStages warps each); rows_shared: estimator rows
// in shared memory (1) or in rows_scratch (0); smem: the block's dynamic
// shared memory in bytes, as est_coder.est_launch_plan computed it (checked
// here against the kernel's own layout); waits: int32 [S, 4] or null
extern "C" int est_encode_launch(const void* slots, const void* bits,
                                 const void* pcabs, const void* valid,
                                 const void* limits, const void* cls,
                                 const void* tbl, const void* apm_row,
                                 const void* pf_tab, void* tok, void* car,
                                 void* count, void* rows_scratch, void* waits,
                                 int S, int T, int NS, int traces,
                                 int rows_shared, int smem, void* stream) {
  if (traces < 1 || traces > kMaxTraces ||
      smem != kTableBytes +
                  traces * (kTraceFixedBytes + (rows_shared ? rows_bytes(NS) : 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rows_shared
          ? launch<true>(slots, bits, pcabs, valid, limits, cls, tbl, apm_row,
                         pf_tab, tok, car, count, rows_scratch, waits, S, T,
                         NS, traces, smem, st)
          : launch<false>(slots, bits, pcabs, valid, limits, cls, tbl, apm_row,
                          pf_tab, tok, car, count, rows_scratch, waits, S, T,
                          NS, traces, smem, st);
  return static_cast<int>(err);
}
