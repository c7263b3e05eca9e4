// Latency of dependent instructions on one GPU: what one step of a serial
// chain costs a single warp.  The port's kernels are serial chains per lane
// or trace, so these numbers, not the card's peak rates, set their floors.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o chip_latency chip_latency.cu
//   ./chip_latency
//
// Each kernel runs one warp over 100,000 dependent steps of one kind and
// reads clock64() around them; the host times the same launch with CUDA
// events, which gives the SM clock.  A step of two instructions is printed
// as their sum.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kSteps = 100000;

template <int OP>
__global__ void chain(uint32_t* out, long long* cycles, uint32_t a, uint32_t b) {
  __shared__ uint32_t sm[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) sm[i] = (i * 7 + 1) & 1023;
  __syncthreads();
  uint32_t x = a + threadIdx.x, y = b;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < kSteps / 8; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (OP == 0) x = x * y + 1u;                     // IMAD
      if (OP == 1) x = (x << 3) ^ y;                   // SHF, LOP3
      if (OP == 2) x = (x ^ y) + 3u;                   // LOP3, IADD3
      if (OP == 3) x = __clz(x | 1u) + y;              // LOP3, FLO, IADD3
      if (OP == 4) x = (x < y) ? x + 7u : x - 5u;      // ISETP, IADD3, SEL
      if (OP == 5) x = sm[x & 1023];                   // LOP3, LDS
      if (OP == 6) x = __funnelshift_r(x, y, x & 31);  // LOP3, SHF (funnel)
      if (OP == 7) {                                   // FLO.SH, IADD3
        asm volatile("bfind.shiftamt.u32 %0, %0;" : "+r"(x));
        x += y;
      }
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

template <int OP>
void run(const char* name) {
  uint32_t* out;
  long long* cycles;
  cudaMalloc(&out, 4096);
  cudaMalloc(&cycles, 8);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  chain<OP><<<1, 32>>>(out, cycles, 12345u, 0x9E3779B1u);  // warm-up
  cudaEventRecord(e0);
  chain<OP><<<1, 32>>>(out, cycles, 12345u, 0x9E3779B1u);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c = 0;
  cudaMemcpy(&c, cycles, 8, cudaMemcpyDeviceToHost);
  printf("%-28s %6.2f cycles a step  %7.3f ns a step  (clock %.3f GHz)\n", name,
         static_cast<double>(c) / kSteps, ms * 1e6 / kSteps, c / (ms * 1e6));
  cudaFree(out);
  cudaFree(cycles);
}

int main() {
  run<0>("IMAD");
  run<1>("SHF + LOP3");
  run<2>("LOP3 + IADD3");
  run<3>("LOP3 + FLO + IADD3 (clz)");
  run<4>("ISETP + IADD3 + SEL");
  run<5>("LOP3 + LDS");
  run<6>("LOP3 + SHF (funnel)");
  run<7>("FLO.SH + IADD3 (bfind)");
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
