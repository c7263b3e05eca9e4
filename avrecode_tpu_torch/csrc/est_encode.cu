// Est-on-device entropy stage for Hopper (sm_90a): the adaptive recode
// model and the range encoder, one serial trace per thread.
//
// Replaces avrecode_tpu/ops/pallas_coder.py::_kernel (the Pallas TPU kernel
// launched by _encode_raw).  Per valid bin: the estimator row at `slot`,
// the 6-input per-class mixer, squash, the APM stage keyed on (class,
// 2-bit history, stretch bucket), requantisation, the mixer update on the
// pre-APM error, the dual-rate counters with per-slot halving limits, and
// the range coder with raw (byte, carry) tokens; then the final flush.
// Same arithmetic as the plain version, est_coder.est_encode_plain, bit for
// bit:
//
//   slots, bits, pcabs, valid  int32 [S, T]   bins; valid != 1 skips a bin
//   limits, cls                int32 [S, NS]  per-slot halving limit, class
//   tbl                        int32 [4096, 2] stretch, squash
//   apm_row                    int32 [33]     identity APM row
//   tok, car                   int32 [S, 2T+2] compacted tokens + flush pair
//                                              (zeroed by the caller)
//   count                      int32 [S]      tokens written, flush included
//   est   int32 [S, NS, 6]           scratch: pos, neg, fpos, fneg, last,
//                                    last2 (initialised here)
//   wts   int32 [S, kNCls, 6]        scratch: mixer weights per class
//   apm   int32 [S, kNCls * 5, 33]   scratch: APM cells per (class, history)
//
// Design: one thread per trace, because each trace is one serial chain of
// dependent bins.  The TPU kernel walked a trace in 1024-bin grid steps with
// the tables in VMEM scratch and (low, pend, rng) in SMEM between steps;
// here the bin loop runs inside the thread, the coder state lives in
// registers for the whole trace, and one segment of tokens is written per
// trace instead of one per chunk.  The read-only stretch/squash table sits
// in shared memory, staged once per block; the mutable model state of each
// trace sits in global scratch, so the kernel is right for any slot count
// (a trace with 3,494 slots would need 84 KB of estimator rows alone).
//
// Bound: latency.  Every bin is a chain of dependent loads (estimator row,
// then mixer weights, then APM cells) through L1/L2, and the next bin may
// read the row this one wrote; there is no parallelism inside a trace, and
// the trace count (hundreds to a few thousand) fills only part of the card.
// Per-trace state in shared memory, a compact row layout and more
// parallelism are left to later work.
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
constexpr int kThreads = 32;
constexpr int kNCls = 79;       // models/trace.py::N_CLS (checked by the wrapper)
constexpr int kApmHist = 5;     // history contexts {00, 01, 10, 11, none}
constexpr int kApmCells = 33;   // APM buckets per (class, history)
constexpr int kHalveFast = 0x18;
constexpr int kWClip = 1 << 24;
constexpr int kTbl = 4096;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
est_encode_kernel(const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ bits,
                  const int32_t* __restrict__ pcabs,
                  const int32_t* __restrict__ valid,
                  const int32_t* __restrict__ limits,
                  const int32_t* __restrict__ cls,
                  const int32_t* __restrict__ tbl,
                  const int32_t* __restrict__ apm_row,
                  int32_t* __restrict__ tok, int32_t* __restrict__ car,
                  int32_t* __restrict__ count, int32_t* __restrict__ est,
                  int32_t* __restrict__ wts, int32_t* __restrict__ apm,
                  int S, int T, int NS) {
  __shared__ int32_t s_stretch[kTbl];
  __shared__ int32_t s_squash[kTbl];
  __shared__ int32_t s_apm_row[kApmCells];
  for (int k = threadIdx.x; k < kTbl; k += blockDim.x) {
    s_stretch[k] = tbl[2 * k];
    s_squash[k] = tbl[2 * k + 1];
  }
  for (int k = threadIdx.x; k < kApmCells; k += blockDim.x) s_apm_row[k] = apm_row[k];
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;

  // this trace's state, initialised as the host model's pools are
  int32_t* e = est + static_cast<size_t>(s) * NS * 6;
  for (int k = 0; k < NS; ++k) {
    int32_t* r = e + k * 6;
    r[0] = r[1] = r[2] = r[3] = 1;
    r[4] = r[5] = 2;  // no last bit yet
  }
  int32_t* w = wts + static_cast<size_t>(s) * kNCls * 6;
  for (int c = 0; c < kNCls; ++c) {
    int32_t* r = w + c * 6;
    r[0] = r[1] = 24576;
    r[2] = r[3] = r[4] = r[5] = 0;
  }
  int32_t* a = apm + static_cast<size_t>(s) * kNCls * kApmHist * kApmCells;
  for (int r = 0; r < kNCls * kApmHist; ++r)
    for (int k = 0; k < kApmCells; ++k) a[r * kApmCells + k] = s_apm_row[k];

  const size_t row = static_cast<size_t>(s) * T;
  const int32_t* lim = limits + static_cast<size_t>(s) * NS;
  const int32_t* cl = cls + static_cast<size_t>(s) * NS;
  int32_t* to = tok + static_cast<size_t>(s) * (2 * static_cast<size_t>(T) + 2);
  int32_t* co = car + static_cast<size_t>(s) * (2 * static_cast<size_t>(T) + 2);

  uint32_t low = 0, rng = 0xFFFFFFFFu;
  int pend = 0, pos = 0;
  for (int i = 0; i < T; ++i) {
    if (valid[row + i] != 1) continue;  // holes too: skip, never stop
    const int slot = slots[row + i];
    const int bit = bits[row + i];
    const int pcab = pcabs[row + i];

    int32_t* er = e + slot * 6;
    const int e0 = er[0], e1 = er[1], f0 = er[2], f1 = er[3];
    const int lb = er[4], lb2 = er[5];
    const int c = cl[slot];
    int32_t* wr = w + c * 6;
    const int w0 = wr[0], w1 = wr[1], w2 = wr[2], w3 = wr[3], w4 = wr[4], w5 = wr[5];

    // mixer inputs: counter probability, CABAC probability, bias, fast
    // counter, last two bits of this slot
    const int pe = clampi((e0 << 16) / (e0 + e1), 1, 0xFFFF);
    const int pf = clampi((f0 << 16) / (f0 + f1), 1, 0xFFFF);
    const int x0 = s_stretch[pe >> 4];
    const int x1 = pcab > 0 ? s_stretch[pcab >> 4] : 0;
    const int x3 = s_stretch[pf >> 4];
    const int x4 = lb == 2 ? 0 : (lb == 1 ? 256 : -256);
    const int x5 = lb2 == 2 ? 0 : (lb2 == 1 ? 128 : -128);
    int dot = ((w0 >> 6) * x0 + (w1 >> 6) * x1 + (w2 >> 6) * 77 +
               (w3 >> 6) * x3 + (w4 >> 6) * x4 + (w5 >> 6) * x5) >> 10;
    dot = clampi(dot, -2048, 2047);

    // APM: interpolate between two cells of the (class, history) row
    const int pmix = s_squash[dot + 2048];
    const int u = s_stretch[pmix >> 4] + 2048;
    const int aj = u >> 7;
    const int frac = u - (aj << 7);
    const int h = (lb == 2 || lb2 == 2) ? 4 : lb * 2 + lb2;
    int32_t* ar = a + (c * kApmHist + h) * kApmCells + aj;
    const int a0 = ar[0], a1 = ar[1];
    const int pa = (a0 * (128 - frac) + a1 * frac) >> 7;
    const int pb = clampi((pmix + pa) >> 1, 1, 65535);
    const int p1 = s_squash[s_stretch[pb >> 4] + 2048];

    const int tgt = bit << 16;
    ar[0] = a0 + (((tgt - a0) * (128 - frac)) >> 13);  // >> (7 + kApmRate)
    ar[1] = a1 + (((tgt - a1) * frac) >> 13);
    const int err = tgt - pmix;  // the mixer learns on its pre-APM output
    wr[0] = clampi(w0 + ((err * x0) >> 14), -kWClip, kWClip);
    wr[1] = clampi(w1 + ((err * x1) >> 14), -kWClip, kWClip);
    wr[2] = clampi(w2 + ((err * 77) >> 14), -kWClip, kWClip);
    wr[3] = clampi(w3 + ((err * x3) >> 14), -kWClip, kWClip);
    wr[4] = clampi(w4 + ((err * x4) >> 14), -kWClip, kWClip);
    wr[5] = clampi(w5 + ((err * x5) >> 14), -kWClip, kWClip);

    // dual-rate counters with the slot's own halving limit
    const int inc1 = bit == 1 ? 1 : 0;
    int e0n = e0 + inc1, e1n = e1 + (1 - inc1);
    int f0n = f0 + inc1, f1n = f1 + (1 - inc1);
    if (e0n + e1n > lim[slot]) {
      e0n = (e0n + 1) >> 1;
      e1n = (e1n + 1) >> 1;
    }
    if (f0n + f1n > kHalveFast) {
      f0n = (f0n + 1) >> 1;
      f1n = (f1n + 1) >> 1;
    }
    er[0] = e0n;
    er[1] = e1n;
    er[2] = f0n;
    er[3] = f1n;
    er[4] = bit;
    er[5] = lb;

    // range coder: put, then up to two renorm byte shifts
    const uint32_t r1 = (rng >> 16) * static_cast<uint32_t>(p1);
    if (bit == 1) {
      rng = r1;
    } else {
      const uint32_t low_a = low + r1;
      pend += low_a < low;  // carry out of the 32-bit low register
      low = low_a;
      rng -= r1;
    }
    for (int k = 0; k < 2 && rng < kTop; ++k) {
      to[pos] = static_cast<int32_t>(low >> 24);
      co[pos] = pend;
      ++pos;
      pend = 0;
      low <<= 8;
      rng <<= 8;
    }
  }

  // shortest-terminator flush: round low up to the next 2^24 multiple,
  // fold its carry into pend, emit the revealed byte and the flush event
  const uint32_t low_r = (low + (kTop - 1)) & 0xFF000000u;
  to[pos] = static_cast<int32_t>(low_r >> 24);
  co[pos] = pend + (low_r < low ? 1 : 0);
  to[pos + 1] = static_cast<int32_t>((low_r >> 16) & 0xFFu);
  co[pos + 1] = 0;
  count[s] = pos + 2;
}

}  // namespace

extern "C" int est_encode_launch(const void* slots, const void* bits,
                                 const void* pcabs, const void* valid,
                                 const void* limits, const void* cls,
                                 const void* tbl, const void* apm_row,
                                 void* tok, void* car, void* count, void* est,
                                 void* wts, void* apm, int S, int T, int NS,
                                 void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  est_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(bits),
      static_cast<const int32_t*>(pcabs), static_cast<const int32_t*>(valid),
      static_cast<const int32_t*>(limits), static_cast<const int32_t*>(cls),
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(apm_row),
      static_cast<int32_t*>(tok), static_cast<int32_t*>(car),
      static_cast<int32_t*>(count), static_cast<int32_t*>(est),
      static_cast<int32_t*>(wts), static_cast<int32_t*>(apm), S, T, NS);
  return static_cast<int>(cudaGetLastError());
}
