// The 12-bit squash-index upload's layout, shared by the fused lane kernel
// (lane_streams.cu, its index form) and the unpack kernel (p1_idx.cu).
//
// Two 12-bit indices into the 4,096-entry squash table fill three bytes,
// the even bin's in the low 12 bits (the JAX package's pack_p1_idx layout),
// so 8 bins are three little-endian 32-bit words.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// 8 bins' indices (words w0, w1, w2) -> their p1 = sq[index], two u16 a
// 32-bit word, bin order; sq is the squash table, in shared memory
__device__ __forceinline__ uint4 unpack8_p1(uint32_t w0, uint32_t w1,
                                            uint32_t w2,
                                            const uint16_t* sq) {
  const uint32_t v0 = sq[w0 & 0xFFFu];
  const uint32_t v1 = sq[(w0 >> 12) & 0xFFFu];
  const uint32_t v2 = sq[__funnelshift_r(w0, w1, 24) & 0xFFFu];
  const uint32_t v3 = sq[(w1 >> 4) & 0xFFFu];
  const uint32_t v4 = sq[(w1 >> 16) & 0xFFFu];
  const uint32_t v5 = sq[__funnelshift_r(w1, w2, 28) & 0xFFFu];
  const uint32_t v6 = sq[(w2 >> 8) & 0xFFFu];
  const uint32_t v7 = sq[w2 >> 20];
  return make_uint4(v0 | (v1 << 16), v2 | (v3 << 16), v4 | (v5 << 16),
                    v6 | (v7 << 16));
}
