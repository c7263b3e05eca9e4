// Unpack of the est stage's per-bin records into the est kernel's rows,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the est problem on the
// host (avrecode_tpu/parallel/pipeline.py::pack_traces, numpy).  It was
// added so that the est path uploads each trace's 8-byte records as the
// native extractor left them, and no host thread derives, zero-fills and
// copies four int32 rows a bin (est_coder.pack_rows):
//
//   table               int64 [n, 2]  (device address, length) of each
//                                     trace's records, rows 0..n-1
//   records             uint64 [len]  lo32 = slot(24) | bit << 24,
//                                     hi32 = pcab(16) | p1 << 16
//   slots, bits, pcabs,
//   valid               int32 [S, T]  row s < n from trace s: slot, bit
//                                     (bit 24 alone), pcab, 1 for t < len;
//                                     0 past len and in rows n..S-1
//
// The same rows as est_coder.est_unpack_plain and pack_rows, bit for bit;
// p1 is not read.
//
// Bound on this card: bytes.  8 read a valid bin and 16 written a padded
// bin, 3.2 GB and ~1 ms at 3.35 TB/s for a group of 18 GOP-long traces
// (S x T ~ 1.3e8), and three masks and shifts a bin.  Design: elementwise;
// blockIdx.y walks the rows, a grid-stride loop in x walks a row, so a
// warp's 8-byte loads cover 256 contiguous bytes and each of its four
// stores 128; the grid holds the card's resident threads once over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxRowBlocks = 65535;  // gridDim.y

__global__ void __launch_bounds__(kThreads)
est_unpack_kernel(const long long* __restrict__ table, int n, int S,
                  long long T, int* __restrict__ slots,
                  int* __restrict__ bits, int* __restrict__ pcabs,
                  int* __restrict__ valid) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const unsigned long long* rec = nullptr;
    long long len = 0;
    if (s < n) {
      rec = reinterpret_cast<const unsigned long long*>(table[2 * s]);
      len = table[2 * s + 1];
    }
    const long long row = static_cast<long long>(s) * T;
#pragma unroll 4
    for (long long t = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         t < T; t += step) {
      int sl = 0, b = 0, pc = 0, v = 0;
      if (t < len) {
        const unsigned long long r = __ldg(rec + t);
        const uint32_t lo = static_cast<uint32_t>(r);
        sl = static_cast<int>(lo & 0xFFFFFFu);
        b = static_cast<int>((lo >> 24) & 1u);
        pc = static_cast<int>((r >> 32) & 0xFFFFu);
        v = 1;
      }
      slots[row + t] = sl;
      bits[row + t] = b;
      pcabs[row + t] = pc;
      valid[row + t] = v;
    }
  }
}

}  // namespace

// table: int64 [n, 2] on the device (each trace's records 8-byte aligned,
// len <= T); slots, bits, pcabs, valid: int32 [S, T]; n <= S.
extern "C" int est_unpack_launch(const void* table, int n, int S,
                                 long long T, void* slots, void* bits,
                                 void* pcabs, void* valid, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = S < kMaxRowBlocks ? S : kMaxRowBlocks;
  const long long per_row = (T + kThreads - 1) / kThreads;
  long long cols = (static_cast<long long>(sms) * kBlocksPerSm + rows - 1) /
                   rows;
  if (cols > per_row) cols = per_row;
  const dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(rows));
  est_unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n, S, T, static_cast<int*>(slots),
      static_cast<int*>(bits), static_cast<int*>(pcabs),
      static_cast<int*>(valid));
  return static_cast<int>(cudaGetLastError());
}
