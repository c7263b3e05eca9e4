// TSan driver for the threaded native paths of the port's host library
// (build: `make -C avrecode_tpu_torch/host tsan_driver`, into
// build/torch_host/; run:
// `tsan_driver [-w WINDOW] <packs.bin> <clip> <clip> <clip>...`).
//
// Exercises everything that spawns threads in libavtpu under
// -fsanitize=thread:
//   - avtpu_compress_mt     (parallel GOP compression, gop scope), equal to
//                           serial, and two serial calls on two threads
//   - avtpu_decompress_mt   (parallel GOP decompression), equal to the input
//   - avtpu_xopen           (parallel GOP trace extraction), and its
//                           counters (avtpu_xstats), written on the GOP
//                           threads and read on the calling thread after
//                           the join, held to their order and printed
//   - avtpu_xopen_lane      (the same extraction in the lane form: each
//                           GOP thread's pass-A scratch, each GOP's codes
//                           grown by mremap), every code read and held to
//                           the u64 records' length and bin, bits 13-15
//                           zero, its counters held to their order
//   - avtpu_lane_pack       (up to 16 threads over the lane rows, two passes
//                           sharing an atomic flag), at a B small enough for
//                           several threads and at B = 4096, and again with
//                           one p1 moved off the squash image so that the
//                           second (u16) pass runs
//   - the extraction window of parallel/pipeline.py::device_compress_corpus:
//     up to WINDOW files at once (-w, default 2; the test passes the
//     pipeline's EXTRACT_WINDOW), each on a std::thread of its own that
//     extracts it on its GOP threads, packs its records into buffers of its
//     own with avtpu_lane_pack and closes its handle, while the other
//     threads still extract; this thread takes the files in order and
//     copies each one's rows (B = 4096) into one shared buffer after the
//     rows before them; the clips in turn, over at least WINDOW + 2 files
//     so that the window refills;
//   - two avtpu_lane_pack calls at once into one set of buffers at disjoint
//     row offsets, as ops/lane_coder.py::LaneBatcher points the packer at a
//     dispatch group's fill row: clip 0 in the index form at row 0, clip 1
//     with a p1 off the squash image (its u16 pass) at the row after, each
//     equal to the same pack into buffers of its own.
// Every pack of the first pass over the clips prints its rows and threads
// and appends its output to <packs.bin> (see pack), which the test
// compares with the Python packers.  Exit 0 = clean; TSan reports make the
// process exit non-zero through TSAN_OPTIONS=exitcode (set by the test).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
size_t avtpu_compress_mt(const uint8_t*, size_t, int, int, uint8_t**);
size_t avtpu_decompress_mt(const uint8_t*, size_t, int, uint8_t**);
void* avtpu_xopen(const uint8_t*, size_t, int, int, int, const uint8_t**,
                  size_t*, size_t*);
void* avtpu_xopen_lane(const uint8_t*, size_t, int, const uint8_t**, size_t*,
                       size_t*);
void avtpu_xlane(void*, size_t, const uint16_t**, size_t*);
void avtpu_xtrace(void*, size_t, const uint64_t**, size_t*, const uint8_t**,
                  const uint8_t**, size_t*);
void avtpu_xclose(void*);
size_t avtpu_xstats(void*, int64_t*, size_t, int64_t*, size_t);
void avtpu_free(uint8_t*);
int avtpu_lane_pack(const uint64_t* const*, const int64_t*, const int64_t*,
                    int, int, int, int64_t, uint8_t*, uint16_t*, int32_t*,
                    int32_t*);
int avtpu_lane_pack_threads(int64_t);
}

namespace {

const int kScopeSlice = 1, kScopeGop = 2, kThreads = 3;
const int kSmallB = 64, kLargeB = 4096;
const uint64_t kForeignP1 = 2;  // under the squash image's least value, 22

std::vector<uint8_t> slurp(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    perror(path);
    exit(2);
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> b(n);
  if (fread(b.data(), 1, n, f) != (size_t)n) exit(2);
  fclose(f);
  return b;
}

void fail(const char* what, const char* clip) {
  fprintf(stderr, "FAIL: %s (%s)\n", what, clip);
  exit(1);
}

std::vector<uint8_t> compress(const std::vector<uint8_t>& in, int scope,
                              int threads) {
  uint8_t* out = nullptr;
  size_t n = avtpu_compress_mt(in.data(), in.size(), scope, threads, &out);
  std::vector<uint8_t> v(out, out + n);
  avtpu_free(out);
  return v;
}

// the extraction counters of a handle (avtpu_xstats): its steps in order,
// passes A and B within the jobs' wall, the jobs' thread CPU within their
// wall and their wall within the pool's, every job inside the GOP phase;
// printed as "xstats WHAT CLIP jobs=J slices=S failed=F threads=T"
void check_xstats(void* h, const char* what, const char* clip) {
  int64_t c[12];
  const size_t n = avtpu_xstats(h, c, 12, nullptr, 0);
  std::vector<int64_t> t(3 * n);
  avtpu_xstats(h, c, 0, t.data(), n);
  const int64_t walked = c[1], joined = c[2], threads = c[4], jobs = c[5];
  const int64_t parse = c[8], model = c[9], job = c[10], cpu = c[11];
  if (jobs != (int64_t)n || jobs < 1 || c[0] > walked || walked > joined ||
      joined > c[3] || parse + model > job || cpu > job ||
      job > threads * (joined - walked))
    fail("extraction counters out of order", clip);
  for (size_t j = 0; j < n; j++)
    if (t[3 * j + 1] < walked || t[3 * j + 1] > t[3 * j + 2] ||
        t[3 * j + 2] > joined)
      fail("a GOP job outside the GOP phase", clip);
  printf("xstats %s %s jobs=%lld slices=%lld failed=%lld threads=%lld\n",
         what, clip, (long long)jobs, (long long)c[6], (long long)c[7],
         (long long)threads);
}

// threaded compress (gop scope) equal to serial; threaded decompress equal
// to the input; threaded extraction, in both forms, with every trace
// buffer touched and its counters read
void threaded_codec(const std::vector<uint8_t>& in, const char* clip) {
  std::vector<uint8_t> mt = compress(in, kScopeGop, kThreads);
  if (mt.empty() || mt != compress(in, kScopeGop, 1))
    fail("mt compress != serial compress", clip);
  uint8_t* dec = nullptr;
  size_t dec_n = avtpu_decompress_mt(mt.data(), mt.size(), kThreads, &dec);
  if (dec_n != in.size() || memcmp(dec, in.data(), dec_n) != 0)
    fail("mt decompress mismatch", clip);
  avtpu_free(dec);

  const uint8_t* meta = nullptr;
  size_t meta_len = 0, n_traces = 0;
  void* h = avtpu_xopen(in.data(), in.size(), kScopeGop, kThreads, 1, &meta,
                        &meta_len, &n_traces);
  if (!h) fail("xopen returned null", clip);
  check_xstats(h, "codec", clip);
  uint64_t sum = 0;
  for (size_t i = 0; i < n_traces; i++) {
    const uint64_t* recs = nullptr;
    const uint8_t *limits = nullptr, *cls = nullptr;
    size_t n = 0, n_slots = 0;
    avtpu_xtrace(h, i, &recs, &n, &limits, &cls, &n_slots);
    for (size_t j = 0; j < n; j++) sum += recs[j];
    for (size_t j = 0; j < n_slots; j++) sum += limits[j] + cls[j];
  }

  // the lane form: the same meta, one code a bin of each trace, its bin
  // the record's; the codes summed for the test to hold to Python's
  const uint8_t* lane_meta = nullptr;
  size_t lane_meta_len = 0, n_lanes = 0;
  void* lh = avtpu_xopen_lane(in.data(), in.size(), kThreads, &lane_meta,
                              &lane_meta_len, &n_lanes);
  if (!lh) fail("xopen_lane returned null", clip);
  check_xstats(lh, "lane", clip);
  if (n_lanes != n_traces || lane_meta_len != meta_len ||
      memcmp(lane_meta, meta, meta_len) != 0)
    fail("the lane form's meta or trace count differs", clip);
  uint64_t lane_sum = 0, bins = 0;
  for (size_t i = 0; i < n_lanes; i++) {
    const uint16_t* codes = nullptr;
    const uint64_t* recs = nullptr;
    const uint8_t *limits = nullptr, *cls = nullptr;
    size_t n = 0, n_recs = 0, n_slots = 0;
    avtpu_xlane(lh, i, &codes, &n);
    avtpu_xtrace(h, i, &recs, &n_recs, &limits, &cls, &n_slots);
    if (n != n_recs) fail("a lane-form trace's length differs", clip);
    for (size_t j = 0; j < n; j++) {
      if ((codes[j] >> 13) || (codes[j] >> 12) != ((recs[j] >> 24) & 1))
        fail("a code's high bits or bin", clip);
      lane_sum += codes[j];
    }
    bins += n;
  }
  avtpu_xclose(lh);
  avtpu_xclose(h);
  printf("codec %s traces=%zu checksum=%016llx\n", clip, n_traces,
         (unsigned long long)sum);
  printf("lane %s traces=%zu bins=%llu sum=%llu\n", clip, n_lanes,
         (unsigned long long)bins, (unsigned long long)lane_sum);
}

struct Extracted {
  void* handle = nullptr;
  std::vector<const uint64_t*> recs;
  std::vector<int64_t> n;
};

// gop-scope extraction without the slot remap, as device_compress_corpus
// calls it (threads 0 = one job a core); `clip` names it where its
// counters are to be read and printed
Extracted extract(const std::vector<uint8_t>& in,
                  const char* clip = nullptr) {
  Extracted x;
  const uint8_t* meta = nullptr;
  size_t meta_len = 0, n_traces = 0;
  x.handle = avtpu_xopen(in.data(), in.size(), kScopeGop, 0, 0, &meta,
                         &meta_len, &n_traces);
  if (x.handle && clip) check_xstats(x.handle, "window", clip);
  for (size_t i = 0; x.handle && i < n_traces; i++) {
    const uint64_t* recs = nullptr;
    const uint8_t *limits = nullptr, *cls = nullptr;
    size_t n = 0, n_slots = 0;
    avtpu_xtrace(x.handle, i, &recs, &n, &limits, &cls, &n_slots);
    x.recs.push_back(recs);
    x.n.push_back((int64_t)n);
  }
  return x;
}

// the lane layout of `n` at B: each trace's first row, and the rows
std::vector<int64_t> lane_starts(const std::vector<int64_t>& n, int B,
                                 int64_t* L) {
  std::vector<int64_t> lane0(n.size());
  *L = 0;
  for (size_t t = 0; t < n.size(); t++) {
    lane0[t] = *L;
    *L += std::max<int64_t>(1, (n[t] + B - 1) / B);
  }
  return lane0;
}

// rows [r0, r0 + L) of the four buffers, Bp bins a row
struct Rows {
  uint8_t* pk;
  uint16_t* p1;
  int32_t* bitw;
  int32_t* lens;
  Rows at(int64_t r0, int Bp) const {
    return {pk + r0 * 3 * Bp / 2, p1 + r0 * Bp, bitw + r0 * Bp / 32,
            lens + r0};
  }
};

struct Buffers {
  std::vector<uint8_t> pk;
  std::vector<uint16_t> p1;
  std::vector<int32_t> bitw, lens;
  Buffers(int64_t L, int Bp)
      : pk((size_t)L * 3 * Bp / 2), p1((size_t)L * Bp),
        bitw((size_t)L * Bp / 32), lens((size_t)L) {}
  Rows rows() { return {pk.data(), p1.data(), bitw.data(), lens.data()}; }
};

int pack_into(const std::vector<const uint64_t*>& recs,
              const std::vector<int64_t>& n, int B, int Bp, Rows dst) {
  int64_t L = 0;
  std::vector<int64_t> lane0 = lane_starts(n, B, &L);
  return avtpu_lane_pack(recs.data(), n.data(), lane0.data(), (int)n.size(),
                         B, Bp, L, dst.pk, dst.p1, dst.bitw, dst.lens);
}

// one avtpu_lane_pack call's header fields and rows
struct Pack {
  int64_t head[10];  // clip, variant, B, Bp, L, form, threads, moved
                     // trace, moved record, 0
  Buffers rows;
  int64_t L() const { return head[4]; }
  int form() const { return (int)head[5]; }
};

// one avtpu_lane_pack call over the traces into buffers of its own, the
// lanes laid out as host/native.py::lane_pack lays them out
Pack pack(int clip, int variant, const std::vector<const uint64_t*>& recs,
          const std::vector<int64_t>& n, int B, int64_t moved_t,
          int64_t moved_r) {
  const int Bp = (B + 255) / 256 * 256;
  int64_t L = 0;
  lane_starts(n, B, &L);
  Pack p{{clip, variant, B, Bp, L, 0, 0, moved_t, moved_r, 0}, Buffers(L, Bp)};
  const int form = pack_into(recs, n, B, Bp, p.rows.rows());
  if (form < 0) {
    fprintf(stderr, "FAIL: lane_pack refused its shapes\n");
    exit(1);
  }
  p.head[5] = form;
  p.head[6] = avtpu_lane_pack_threads(L);
  return p;
}

// prints the pack and appends to `out` its ten int64 header fields, then
// bitw int32 [L, Bp / 32], lens int32 [L] and pk uint8 [L, 3 * Bp / 2]
// (form 1) or p1 uint16 [L, Bp] (form 0)
void write_pack(FILE* out, const Pack& p) {
  const int64_t* h = p.head;
  printf("pack clip=%lld variant=%lld B=%lld rows=%lld threads=%lld "
         "form=%lld\n", (long long)h[0], (long long)h[1], (long long)h[2],
         (long long)h[4], (long long)h[6], (long long)h[5]);
  fwrite(h, sizeof p.head, 1, out);
  fwrite(p.rows.bitw.data(), sizeof(int32_t), p.rows.bitw.size(), out);
  fwrite(p.rows.lens.data(), sizeof(int32_t), p.rows.lens.size(), out);
  if (p.form())
    fwrite(p.rows.pk.data(), 1, p.rows.pk.size(), out);
  else
    fwrite(p.rows.p1.data(), sizeof(uint16_t), p.rows.p1.size(), out);
}

// the packs of one clip's records: as extracted at both B, then with the
// middle record of the first non-empty trace moved off the squash image
std::vector<Pack> pack_clip(int clip, const Extracted& x) {
  std::vector<Pack> packs;
  packs.push_back(pack(clip, 0, x.recs, x.n, kSmallB, -1, -1));
  packs.push_back(pack(clip, 0, x.recs, x.n, kLargeB, -1, -1));
  size_t t = 0;
  while (t < x.n.size() && !x.n[t]) t++;
  if (t == x.n.size()) return packs;
  std::vector<uint64_t> copy(x.recs[t], x.recs[t] + x.n[t]);
  const int64_t r = x.n[t] / 2;
  copy[r] = (copy[r] & ((1ull << 48) - 1)) | kForeignP1 << 48;
  std::vector<const uint64_t*> recs = x.recs;
  recs[t] = copy.data();
  packs.push_back(pack(clip, 1, recs, x.n, kSmallB, (int64_t)t, r));
  return packs;
}

template <class T>
bool same_rows(const std::vector<T>& a, int64_t a0, const std::vector<T>& b,
               int64_t rows, size_t width) {
  return std::equal(b.begin(), b.begin() + rows * width,
                    a.begin() + a0 * width);
}

// two packs at once into one set of buffers at disjoint row offsets, each
// equal to its own pack
void shared_packs(const Extracted& x0, const Extracted& x1, const char* clip) {
  const int B = kSmallB, Bp = 256;
  size_t t = 0;
  while (t < x1.n.size() && !x1.n[t]) t++;
  if (t == x1.n.size()) fail("no records to move off the image", clip);
  std::vector<uint64_t> copy(x1.recs[t], x1.recs[t] + x1.n[t]);
  copy[0] = (copy[0] & ((1ull << 48) - 1)) | kForeignP1 << 48;
  std::vector<const uint64_t*> recs1 = x1.recs;
  recs1[t] = copy.data();
  int64_t L0 = 0, L1 = 0;
  lane_starts(x0.n, B, &L0);
  lane_starts(x1.n, B, &L1);
  Buffers one(L0, Bp), two(L1, Bp), both(L0 + L1, Bp);
  const int f0 = pack_into(x0.recs, x0.n, B, Bp, one.rows());
  const int f1 = pack_into(recs1, x1.n, B, Bp, two.rows());
  int g1 = -1;
  std::thread other(
      [&] { g1 = pack_into(recs1, x1.n, B, Bp, both.rows().at(L0, Bp)); });
  const int g0 = pack_into(x0.recs, x0.n, B, Bp, both.rows());
  other.join();
  const size_t wp = 3 * Bp / 2, ww = Bp / 32;
  if (f0 != 1 || f1 != 0 || g0 != f0 || g1 != f1 ||
      !same_rows(both.pk, 0, one.pk, L0, wp) ||
      !same_rows(both.p1, L0, two.p1, L1, Bp) ||
      !same_rows(both.bitw, 0, one.bitw, L0, ww) ||
      !same_rows(both.bitw, L0, two.bitw, L1, ww) ||
      !same_rows(both.lens, 0, one.lens, L0, 1) ||
      !same_rows(both.lens, L0, two.lens, L1, 1))
    fail("packs into one buffer differ from packs of their own", clip);
  printf("shared pack rows=%lld+%lld forms=%d,%d equal\n", (long long)L0,
         (long long)L1, g0, g1);
}

}  // namespace

int main(int argc, char** argv) {
  int window = 2;
  if (argc > 2 && strcmp(argv[1], "-w") == 0) {
    window = atoi(argv[2]);
    argv += 2;
    argc -= 2;
  }
  if (argc < 5 || window < 1) {
    fprintf(stderr,
            "usage: %s [-w WINDOW] <packs.bin> <clip> <clip> <clip>...\n",
            argv[0]);
    return 2;
  }
  const int n_clips = argc - 2;
  std::vector<std::vector<uint8_t>> in;
  for (int k = 0; k < n_clips; k++) in.push_back(slurp(argv[2 + k]));
  for (int k = 0; k < n_clips; k++) threaded_codec(in[k], argv[2 + k]);

  // two serial compress calls at once (a caller's threads, the GIL
  // released), each equal to the same call made alone
  {
    std::vector<uint8_t> want0 = compress(in[0], kScopeSlice, 1);
    std::vector<uint8_t> want1 = compress(in[1], kScopeSlice, 1);
    std::vector<uint8_t> got1;
    std::thread other([&] { got1 = compress(in[1], kScopeSlice, 1); });
    std::vector<uint8_t> got0 = compress(in[0], kScopeSlice, 1);
    other.join();
    if (got0 != want0 || got1 != want1)
      fail("concurrent compress calls differ from serial", argv[2]);
  }

  // the corpus window: up to `window` files at once, each on a thread
  // that extracts it (reading its counters), packs its records into
  // buffers of its own and closes its handle while the threads after it
  // still extract; this
  // thread takes the files in order (file k + window starts once file k
  // is taken), writes the packs of the first pass over the clips to
  // <packs.bin> and copies each file's rows at B = kLargeB into one
  // shared buffer after the rows before them
  FILE* out = fopen(argv[1], "wb");
  if (!out) {
    perror(argv[1]);
    return 2;
  }
  const int n_files = std::max(n_clips, window + 2);
  std::vector<std::vector<Pack>> packed(n_files);
  std::vector<std::thread> working(n_files);
  auto start = [&](int k) {
    working[k] = std::thread([&, k] {
      Extracted x = extract(in[k % n_clips], argv[2 + k % n_clips]);
      if (!x.handle) fail("xopen returned null", argv[2 + k % n_clips]);
      packed[k] = pack_clip(k % n_clips, x);
      avtpu_xclose(x.handle);
    });
  };
  std::vector<uint8_t> shared_pk;
  std::vector<int32_t> shared_bitw, shared_lens;
  int64_t rows = 0;
  for (int k = 0; k < std::min(window, n_files); k++) start(k);
  for (int k = 0; k < n_files; k++) {
    working[k].join();
    if (k + window < n_files) start(k + window);
    std::vector<Pack> packs = std::move(packed[k]);
    if (k < n_clips)
      for (const Pack& p : packs) write_pack(out, p);
    const Pack& p = packs[1];  // B = kLargeB, as extracted
    if (!p.form()) fail("a pack at B = 4096 left the index form", argv[2]);
    const Buffers& b = p.rows;
    shared_pk.insert(shared_pk.end(), b.pk.begin(), b.pk.end());
    shared_bitw.insert(shared_bitw.end(), b.bitw.begin(), b.bitw.end());
    shared_lens.insert(shared_lens.end(), b.lens.begin(), b.lens.end());
    rows += p.L();
  }
  fclose(out);
  const int Bp = (kLargeB + 255) / 256 * 256;
  if (shared_pk.size() != (size_t)rows * 3 * Bp / 2 ||
      shared_lens.size() != (size_t)rows)
    fail("the shared buffer's rows differ from the packs'", argv[2]);
  printf("corpus window=%d files=%d rows=%lld\n", window, n_files,
         (long long)rows);

  Extracted x0 = extract(in[0]), x1 = extract(in[1]);
  if (!x0.handle || !x1.handle) fail("xopen returned null", argv[2]);
  shared_packs(x0, x1, argv[3]);
  avtpu_xclose(x0.handle);
  avtpu_xclose(x1.handle);
  printf("OK clips=%d\n", n_clips);
  return 0;
}
