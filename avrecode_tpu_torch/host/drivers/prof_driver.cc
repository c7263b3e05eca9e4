// Standalone profiling driver: serial compress / decompress / extract of a
// file N times, for gprof / timing work on the native hot path.
// Build: `make -C avrecode_tpu_torch/host prof`, into build/torch_host/.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <chrono>
#include <sys/resource.h>

static double cpu_s() {
  rusage r;
  getrusage(RUSAGE_SELF, &r);
  return r.ru_utime.tv_sec + r.ru_utime.tv_usec * 1e-6 + r.ru_stime.tv_sec +
         r.ru_stime.tv_usec * 1e-6;
}

extern "C" {
size_t avtpu_compress_mt(const uint8_t* data, size_t size, int scope,
                         int threads, uint8_t** out);
size_t avtpu_decompress_mt(const uint8_t* data, size_t size, int threads,
                           uint8_t** out);
void* avtpu_xopen(const uint8_t* data, size_t size, int scope, int threads,
                  int want_slots, const uint8_t** meta, size_t* meta_len,
                  size_t* n_traces);
void avtpu_xclose(void* h);
void avtpu_free(uint8_t* p);
}

static std::vector<uint8_t> slurp(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) { perror(path); exit(1); }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> v(n);
  if (fread(v.data(), 1, n, f) != (size_t)n) exit(1);
  fclose(f);
  return v;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <file.mp4> [reps] [mode=c|d|x|r] [threads]\n",
            argv[0]);
    return 2;
  }
  auto data = slurp(argv[1]);
  int reps = argc > 2 ? atoi(argv[2]) : 5;
  char mode = argc > 3 ? argv[3][0] : 'c';
  int threads = argc > 4 ? atoi(argv[4]) : 1;
  const int scope = 2;  // gop

  uint8_t* comp = nullptr;
  size_t comp_n =
      avtpu_compress_mt(data.data(), data.size(), scope, threads, &comp);

  auto t0 = std::chrono::steady_clock::now();
  double c0 = cpu_s();
  for (int i = 0; i < reps; i++) {
    if (mode == 'c' || mode == 'r') {
      uint8_t* out = nullptr;
      size_t n =
          avtpu_compress_mt(data.data(), data.size(), scope, threads, &out);
      if (!n) { fprintf(stderr, "compress failed\n"); return 1; }
      if (mode == 'r') {
        uint8_t* rt = nullptr;
        size_t rn = avtpu_decompress_mt(out, n, threads, &rt);
        if (rn != data.size() || memcmp(rt, data.data(), rn)) {
          fprintf(stderr, "roundtrip mismatch\n");
          return 1;
        }
        avtpu_free(rt);
      }
      avtpu_free(out);
    } else if (mode == 'd') {
      uint8_t* out = nullptr;
      size_t n = avtpu_decompress_mt(comp, comp_n, threads, &out);
      if (n != data.size()) { fprintf(stderr, "decompress failed\n"); return 1; }
      avtpu_free(out);
    } else if (mode == 'x') {
      const uint8_t* meta;
      size_t meta_len, n_traces;
      void* h = avtpu_xopen(data.data(), data.size(), scope, threads, 0,
                            &meta, &meta_len, &n_traces);
      if (!h) { fprintf(stderr, "extract failed\n"); return 1; }
      avtpu_xclose(h);
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  double s = std::chrono::duration<double>(t1 - t0).count();
  double cs = cpu_s() - c0;
  double mb = data.size() * reps / 1e6;
  printf(
      "{\"mode\":\"%c\",\"threads\":%d,\"mb_s\":%.3f,\"cpu_mb_s\":%.3f,"
      "\"s\":%.3f,\"cpu_s\":%.3f,\"ratio\":%.4f}\n",
      mode, threads, mb / s, mb / cs, s, cs, (double)comp_n / data.size());
  avtpu_free(comp);
  return 0;
}
