// Latency of dependent instructions on one GPU: what one step of a serial
// chain costs a single warp.  The port's kernels are serial chains per lane
// or trace, so these numbers, not the card's peak rates, set their floors.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o chip_latency chip_latency.cu
//   ./chip_latency
//   ./chip_latency where BLOCKS THREADS SMEM_BYTES   # warps to schedulers
//
// Each kernel runs one warp over 100,000 dependent steps of one kind and
// reads clock64() around them; the host times the same launch with CUDA
// events, which gives the SM clock.  A step of two instructions is printed
// as their sum.  The last three lines are the loop-carried paths of one
// est_encode bin (est_chain), from which the est kernel's chain floor a
// bin is the longest.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
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

// The loop-carried paths of one est_encode bin (csrc/est_encode.cu's serial
// phase), each run as a chain of dependent steps with the kernel's
// operations and a shared-memory table: kind 0, the mixer weights, where a
// bin's class repeats (the six-term dot, its clamp, the squash lookup, the
// error, the six clamped updates that the next dot reads); kind 1, an APM
// cell, where a bin's cell repeats (the load after the last bin's store,
// the update, the store); kind 2, the estimator row, where a bin's slot
// repeats (the counters unpacked, counted, halved at the limit and packed
// again; the division and the stretch lookup of pack_row feed the next
// bin's mixer input, not the row).  The longest of these and the range
// coder's (LANE: 53 cycles) is the chain a trace's bins wait on.
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int KIND>
__global__ void est_chain(int* out, long long* cycles, const int* xs) {
  __shared__ uint16_t s_tab[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    s_tab[i] = static_cast<uint16_t>((i * 37 + 11) & 0xFFFF);
  __syncthreads();
  const int x0 = xs[0], x1 = xs[1], x3 = xs[2], x4 = xs[3], x5 = xs[4];
  const int limit = xs[5], frac = xs[6] & 127, cell = xs[7] & 4095;
  int w0 = xs[8], w1 = xs[9], w2 = xs[10], w3 = xs[11], w4 = xs[12],
      w5 = xs[13];
  uint32_t row = static_cast<uint32_t>(xs[14]);
  volatile uint16_t* ar = s_tab + cell;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < kSteps; ++i) {
    const int tgt = ((i >> 1) & 1) << 16;
    if (KIND == 0) {
      int dot = ((w0 >> 6) * x0 + (w1 >> 6) * x1 + (w2 >> 6) * 77 +
                 (w3 >> 6) * x3 + (w4 >> 6) * x4 + (w5 >> 6) * x5) >> 10;
      dot = clampi(dot, -2048, 2047);
      const int err = tgt - s_tab[dot + 2048];
      w0 = clampi(w0 + ((err * x0) >> 14), -(1 << 24), 1 << 24);
      w1 = clampi(w1 + ((err * x1) >> 14), -(1 << 24), 1 << 24);
      w2 = clampi(w2 + ((err * 77) >> 14), -(1 << 24), 1 << 24);
      w3 = clampi(w3 + ((err * x3) >> 14), -(1 << 24), 1 << 24);
      w4 = clampi(w4 + ((err * x4) >> 14), -(1 << 24), 1 << 24);
      w5 = clampi(w5 + ((err * x5) >> 14), -(1 << 24), 1 << 24);
    } else if (KIND == 1) {
      const int a0 = ar[0];
      ar[0] = static_cast<uint16_t>(a0 + (((tgt - a0) * (128 - frac)) >> 13));
    } else {
      const int bit = tgt >> 16;
      int e0 = (row & 0x7FFF) + bit, e1 = ((row >> 15) & 0x7FFF) + 1 - bit;
      if (e0 + e1 > limit) {
        e0 = (e0 + 1) >> 1;
        e1 = (e1 + 1) >> 1;
      }
      row = static_cast<uint32_t>(e0) | (static_cast<uint32_t>(e1) << 15) |
            (static_cast<uint32_t>(bit) << 30);
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = w0 ^ w1 ^ w2 ^ w3 ^ w4 ^ w5 ^ static_cast<int>(row) ^ ar[0];
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

template <int KIND>
void run_est(const char* name) {
  int* out;
  long long* cycles;
  int* xs;
  const int h[15] = {-700, 300, 500, 256, -128, 0x60, 45, 1234,
                     24576, 24576, 0, 0, 0, 0, 3 | (5 << 15)};
  cudaMalloc(&out, 4096);
  cudaMalloc(&cycles, 8);
  cudaMalloc(&xs, sizeof h);
  cudaMemcpy(xs, h, sizeof h, cudaMemcpyHostToDevice);
  est_chain<KIND><<<1, 32>>>(out, cycles, xs);  // warm-up
  cudaDeviceSynchronize();
  est_chain<KIND><<<1, 32>>>(out, cycles, xs);
  long long c = 0;
  cudaMemcpy(&c, cycles, 8, cudaMemcpyDeviceToHost);
  printf("%-28s %6.2f cycles a step\n", name, static_cast<double>(c) / kSteps);
  cudaFree(out);
  cudaFree(cycles);
  cudaFree(xs);
}

// Where the warps of a launch land: each warp records its SM (%smid) and
// its warp slot on the SM (%warpid), whose value mod 4 names the SM's
// sub-partition, i.e. the warp scheduler that issues for it.  The warps
// spin for a while, so that every block of the launch is resident at once.
__global__ void where(int* out, long long spin) {
  if ((threadIdx.x & 31) == 0) {
    int sm, wid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(wid));
    const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    out[2 * w] = sm;
    out[2 * w + 1] = wid;
  }
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {
  }
}

// `./chip_latency where BLOCKS THREADS SMEM_BYTES`: how many blocks put
// their warps on as many different schedulers as they have warps (up to 4),
// how many schedulers of each SM got a warp, and which warps share one: for
// every pair of a block's warp indices (a, b), the schedulers that hold a
// warp of index a and another of index b, of the same block or of another
// block on the SM.  A kernel that gives its warps roles by index reads from
// this which roles compete for a scheduler's issue slots.
int where_report(int blocks, int threads, int smem) {
  const int warps = threads / 32, n = blocks * warps;
  int* d;
  cudaMalloc(&d, 8 * n);
  cudaFuncSetAttribute(where, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  where<<<blocks, threads, smem>>>(d, 2000000);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  int* h = new int[2 * n];
  cudaMemcpy(h, d, 8 * n, cudaMemcpyDeviceToHost);
  int apart = 0, sms = 0, used[4] = {0, 0, 0, 0}, most = 0;
  for (int b = 0; b < blocks; ++b) {
    int mask = 0;
    for (int w = 0; w < warps; ++w)
      mask |= 1 << (h[2 * (b * warps + w) + 1] & 3);
    apart += __builtin_popcount(mask) == (warps < 4 ? warps : 4);
  }
  int* pairs = new int[warps * warps]();
  for (int sm = 0; sm < 1024; ++sm) {
    int mask = 0, on_sm = 0;
    for (int w = 0; w < n; ++w)
      if (h[2 * w] == sm) mask |= 1 << (h[2 * w + 1] & 3), ++on_sm;
    if (mask) ++sms, ++used[__builtin_popcount(mask) - 1];
    most = on_sm > most ? on_sm : most;
  }
  for (int v = 0; v < n; ++v)  // the pairs of warps on one scheduler
    for (int u = 0; u < n; ++u)
      if (u != v && h[2 * v] == h[2 * u] &&
          (h[2 * v + 1] & 3) == (h[2 * u + 1] & 3))
        ++pairs[(v % warps) * warps + u % warps];
  printf("where %d blocks x %d threads, %d B shared: %d of %d blocks have "
         "their warps on distinct schedulers; %d SMs used (at most %d warps "
         "on one), with 1/2/3/4 schedulers busy: %d/%d/%d/%d\n",
         blocks, threads, smem, apart, blocks, sms, most, used[0], used[1],
         used[2], used[3]);
  printf("warp index pairs sharing a scheduler (a: b x count):\n");
  for (int a = 0; a < warps; ++a) {
    printf("  warp %d:", a);
    for (int b = 0; b < warps; ++b)
      if (pairs[a * warps + b]) printf(" %d x %d", b, pairs[a * warps + b]);
    printf("\n");
  }
  delete[] pairs;
  delete[] h;
  cudaFree(d);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 5 && std::string(argv[1]) == "where")
    return where_report(atoi(argv[2]), atoi(argv[3]), atoi(argv[4]));
  run<0>("IMAD");
  run<1>("SHF + LOP3");
  run<2>("LOP3 + IADD3");
  run<3>("LOP3 + FLO + IADD3 (clz)");
  run<4>("ISETP + IADD3 + SEL");
  run<5>("LOP3 + LDS");
  run<6>("LOP3 + SHF (funnel)");
  run<7>("FLO.SH + IADD3 (bfind)");
  run_est<0>("est bin: mixer weights");
  run_est<1>("est bin: an APM cell");
  run_est<2>("est bin: estimator row");
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
