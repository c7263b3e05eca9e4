// Unpack of the 12-bit squash-index upload, for Hopper (sm_90a).
//
// Replaces the unpack and take of avrecode_tpu/ops/lane_coder.py::
// _lane_pipeline_idx_jit (XLA there, ahead of the Pallas kernel): packed
// indices uint8 [L, 3 * Bp / 2] (two 12-bit indices in three bytes, the
// even bin's in the low 12 bits) -> uint16 p1 [L, Bp] = sq[index], sq the
// 4,096-entry squash table.  The fused lane kernel (lane_streams.cu) reads
// the indices itself; the lane path calls this one only where lane_collect
// codes an index-form group again with lane_encode (the overflow fallback).
//
// Bound on this card: bytes, 1.5 read and 2 written a bin, 470 MB and 0.14
// ms at [8192, 16384] and 3.35 TB/s; a handful of integer operations a bin.
// Design: elementwise.  A thread takes 8 bins at a time: three 4-byte loads
// (12 bytes; a warp's loads cover 384 contiguous bytes), eight 12-bit fields
// looked up in the table, which each block copies into shared memory first,
// and one 16-byte store.  A grid-stride loop over the 8-bin groups, a few
// blocks an SM, so that the table copy is paid a few times an SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "squash_idx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
unpack_p1_idx_kernel(const uint32_t* __restrict__ pk,
                     const uint4* __restrict__ sq, uint4* __restrict__ p1,
                     long long n_groups) {
  __shared__ __align__(16) uint16_t s_sq[4096];
  for (int k = threadIdx.x; k < 4096 / 8; k += kThreads)
    reinterpret_cast<uint4*>(s_sq)[k] = sq[k];
  __syncthreads();
  for (long long g = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       g < n_groups; g += static_cast<long long>(gridDim.x) * kThreads)
    p1[g] = unpack8_p1(pk[3 * g], pk[3 * g + 1], pk[3 * g + 2],
                       reinterpret_cast<const unsigned char*>(s_sq));
}

}  // namespace

// pk: uint8 [L, 3 * Bp / 2] packed indices (4-byte aligned); sq: uint16
// [4096] on the device (16-byte aligned); p1: uint16 [L, Bp] (16-byte
// aligned); n_groups = L * Bp / 8.
extern "C" int unpack_p1_idx_launch(const void* pk, const void* sq, void* p1,
                                    long long n_groups, void* stream) {
  if (n_groups <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n_groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < static_cast<long long>(sms) * kBlocksPerSm
          ? want
          : static_cast<long long>(sms) * kBlocksPerSm);
  unpack_p1_idx_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pk), static_cast<const uint4*>(sq),
      static_cast<uint4*>(p1), n_groups);
  return static_cast<int>(cudaGetLastError());
}
