// Lane-parallel estimator-free range encoder for Hopper (sm_90a).
//
// Replaces avrecode_tpu/ops/lane_coder.py::_lane_kernel (the Pallas TPU
// kernel launched by _lane_encode_pallas_jit).  Same inputs as the compact
// device upload of the main path, same outputs bit for bit:
//
//   p1   uint16 [L, Bp]       exact per-bin model probability of a 1
//   bitw int32  [L, Bp / 32]  the bins' bits, little-endian 32-bit words
//   lens int32  [L]           valid bins per lane (bins past it are frozen)
//   tok  int32  [L, Bp]       byte0 | byte1 << 8 | n_emitted << 16
//   car  int32  [L, Bp]       pending-carry count attached to byte0
//   ftok int32  [L]           flush bytes byte0 | byte1 << 8
//   fcar int32  [L]           pending-carry count of the flush byte0
//
// Design: one thread per lane.  The TPU kernel walked 1024 lanes per vector
// op along a sequential bin-chunk grid axis and kept (low, pend, rng) in
// VMEM scratch between chunks; here the bin loop runs inside the thread and
// the state lives in three uint32 registers for the whole lane, so the
// flush is written once at the end instead of after every chunk.  uint32
// arithmetic gives the mod-2^32 wrap the TPU got from int32, and unsigned
// compares replace its sign-flip trick.
//
// Bound: each lane is one serial dependent chain of B bins, and the
// parallelism is the lane count (8192 lanes on 132 SMs for a full dispatch
// group), so the kernel is latency-bound, not bandwidth-bound.  Inputs and
// outputs are lanes-major, so neighbouring threads touch addresses Bp
// elements apart (uncoalesced; L1 absorbs the sequential per-thread reads).
// A bins-major layout, shared-memory staging and fusing the finalize are
// left to later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kThreads = 64;

__global__ void lane_encode_kernel(const uint16_t* __restrict__ p1,
                                   const uint32_t* __restrict__ bitw,
                                   const int32_t* __restrict__ lens,
                                   int32_t* __restrict__ tok,
                                   int32_t* __restrict__ car,
                                   int32_t* __restrict__ ftok,
                                   int32_t* __restrict__ fcar,
                                   int L, int Bp) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const size_t row = static_cast<size_t>(lane) * Bp;
  const uint16_t* pr = p1 + row;
  const uint32_t* wr = bitw + static_cast<size_t>(lane) * (Bp / 32);
  int32_t* tr = tok + row;
  int32_t* cr = car + row;

  int n_valid = lens[lane];
  n_valid = n_valid < 0 ? 0 : (n_valid > Bp ? Bp : n_valid);

  uint32_t low = 0, pend = 0, rng = 0xFFFFFFFFu;
  uint32_t word = 0;
  for (int i = 0; i < n_valid; ++i) {
    if ((i & 31) == 0) word = wr[i >> 5];
    const uint32_t bit = (word >> (i & 31)) & 1u;
    const uint32_t r1 = (rng >> 16) * static_cast<uint32_t>(pr[i]);
    uint32_t low_n, rng_n;
    if (bit) {
      low_n = low;
      rng_n = r1;
    } else {
      low_n = low + r1;
      pend += low_n < low;  // carry out of the 32-bit low register
      rng_n = rng - r1;
    }
    // the byte fields are taken whether or not the renorm fires, exactly
    // as the TPU kernel computes them
    const uint32_t tok0 = low_n >> 24;
    uint32_t car0 = 0, n = 0;
    if (rng_n < kTop) {
      car0 = pend;
      pend = 0;
      low_n <<= 8;
      rng_n <<= 8;
      n = 1;
    }
    const uint32_t tok1 = low_n >> 24;
    if (rng_n < kTop) {
      low_n <<= 8;
      rng_n <<= 8;
      ++n;
    }
    low = low_n;
    rng = rng_n;
    tr[i] = static_cast<int32_t>(tok0 | (tok1 << 8) | (n << 16));
    cr[i] = static_cast<int32_t>(car0);
  }
  for (int i = n_valid; i < Bp; ++i) {
    tr[i] = 0;
    cr[i] = 0;
  }
  // shortest-terminator flush from the frozen state: round low up to the
  // next 2^24 multiple, then two byte shifts
  const uint32_t low_r = (low + (kTop - 1)) & 0xFF000000u;
  fcar[lane] = static_cast<int32_t>(pend + (low_r < low ? 1u : 0u));
  ftok[lane] = static_cast<int32_t>((low_r >> 24) | (((low_r >> 16) & 0xFFu) << 8));
}

}  // namespace

extern "C" int lane_encode_launch(const void* p1, const void* bitw,
                                  const void* lens, void* tok, void* car,
                                  void* ftok, void* fcar, int L, int Bp,
                                  void* stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  lane_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
