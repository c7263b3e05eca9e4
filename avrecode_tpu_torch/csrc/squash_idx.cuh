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
// 32-bit word, bin order.  sq is the squash table in static shared memory,
// at an address the compiler knows: each field is taken out already
// doubled, as a byte offset into the table, so that a lookup is one load
// at offset + table and needs no address arithmetic.
__device__ __forceinline__ uint4 unpack8_p1(uint32_t w0, uint32_t w1,
                                            uint32_t w2,
                                            const unsigned char* sq) {
  auto at = [sq](uint32_t offset) -> uint32_t {
    return *reinterpret_cast<const uint16_t*>(sq + offset);
  };
  const uint32_t v0 = at((w0 << 1) & 0x1FFEu);
  const uint32_t v1 = at((w0 >> 11) & 0x1FFEu);
  const uint32_t v2 = at(__funnelshift_r(w0, w1, 23) & 0x1FFEu);
  const uint32_t v3 = at((w1 >> 3) & 0x1FFEu);
  const uint32_t v4 = at((w1 >> 15) & 0x1FFEu);
  const uint32_t v5 = at(__funnelshift_r(w1, w2, 27) & 0x1FFEu);
  const uint32_t v6 = at((w2 >> 7) & 0x1FFEu);
  const uint32_t v7 = at((w2 >> 19) & 0x1FFEu);
  return make_uint4(v0 | (v1 << 16), v2 | (v3 << 16), v4 | (v5 << 16),
                    v6 | (v7 << 16));
}
