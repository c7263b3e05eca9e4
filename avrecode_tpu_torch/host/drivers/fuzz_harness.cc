// Fuzz harness for the port's native library: mutated containers and
// mutated video inputs through the C API.  Built with ASan (`make -C
// avrecode_tpu_torch/host fuzz`, into build/torch_host/) so memory
// violations abort; exceptions must be contained by the C API.
// Usage: fuzz_harness <clip> <seed> <trials>
//
// Each trial
//   - decompresses a mutated container (bit flips, a truncation or a
//     scrambled run), which may fail but must not crash;
//   - compresses a mutated input (bit flips anywhere, or, in an AVI, in the
//     header of a RIFF LIST: `movi`, `rec ` and the rest), which must
//     decompress back to the mutated input byte for byte when it compresses;
//   - extracts the same mutated input's traces and lane-packs them, and
//     checks every packed row against the records it came from.
// Prints FUZZ_OK and counts of what each step did.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "../src/mix_tables.h"

extern "C" {
size_t avtpu_compress_mt(const uint8_t*, size_t, int, int, uint8_t**);
size_t avtpu_decompress_mt(const uint8_t*, size_t, int, uint8_t**);
void* avtpu_xopen(const uint8_t*, size_t, int, int, int, const uint8_t**,
                  size_t*, size_t*);
void avtpu_xtrace(void*, size_t, const uint64_t**, size_t*, const uint8_t**,
                  const uint8_t**, size_t*);
void avtpu_xclose(void*);
void avtpu_free(uint8_t*);
int avtpu_lane_pack(const uint64_t* const*, const int64_t*, const int64_t*,
                    int, int, int, int64_t, uint8_t*, uint16_t*, int32_t*,
                    int32_t*);
}

static uint64_t rng_state;
static uint32_t xrnd() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return (uint32_t)(rng_state >> 32);
}

static const int kScopeGop = 2, kLaneB = 64, kLaneBp = 256;

// offsets of the RIFF and LIST chunk headers (fourcc, size, list type)
static std::vector<size_t> riff_lists(const std::vector<uint8_t>& v) {
  std::vector<size_t> at;
  for (size_t i = 0; i + 12 <= v.size(); i++)
    if (!memcmp(&v[i], "LIST", 4) || !memcmp(&v[i], "RIFF", 4))
      at.push_back(i);
  return at;
}

// lane row r of a pack against its records: lens, bit words, p1 (through
// the squash table in the index form), zeros past the lane's bins
static bool row_ok(const uint64_t* rec, int n, int form, const uint8_t* pk,
                   const uint16_t* p1, const int32_t* bitw) {
  for (int b = 0; b < kLaneBp; b++) {
    const uint64_t r = b < n ? rec[b] : 0;
    const uint32_t bit = (uint32_t)bitw[b >> 5] >> (b & 31) & 1;
    uint32_t got;
    if (form) {
      const uint8_t* q = pk + 3 * (b >> 1);
      const uint32_t idx =
          b & 1 ? (q[1] >> 4) | (q[2] << 4) : q[0] | (q[1] & 0xF) << 8;
      if (b >= n) {
        if (idx) return false;
        got = 0;
      } else {
        got = avtpu::kSquash[idx];
      }
    } else {
      got = p1[b];
    }
    if (bit != ((r >> 24) & 1) || got != (uint32_t)(r >> 48)) return false;
  }
  return true;
}

// extract and lane-pack an input; false where a packed row disagrees with
// its records.  *rows gains the rows packed.
static bool extract_and_pack(const std::vector<uint8_t>& vid, long* rows) {
  const uint8_t* meta = nullptr;
  size_t meta_len = 0, n_traces = 0;
  void* h = avtpu_xopen(vid.data(), vid.size(), kScopeGop, 1, 0, &meta,
                        &meta_len, &n_traces);
  if (!h) return true;
  std::vector<const uint64_t*> recs(n_traces);
  std::vector<int64_t> n(n_traces), lane0(n_traces);
  int64_t L = 0;
  for (size_t i = 0; i < n_traces; i++) {
    size_t cnt = 0, n_slots = 0;
    const uint8_t *limits = nullptr, *cls = nullptr;
    avtpu_xtrace(h, i, &recs[i], &cnt, &limits, &cls, &n_slots);
    n[i] = (int64_t)cnt;
    lane0[i] = L;
    L += std::max<int64_t>(1, (n[i] + kLaneB - 1) / kLaneB);
  }
  std::vector<uint8_t> pk((size_t)L * 3 * kLaneBp / 2);
  std::vector<uint16_t> p1((size_t)L * kLaneBp);
  std::vector<int32_t> bitw((size_t)L * kLaneBp / 32), lens((size_t)L);
  const int form = avtpu_lane_pack(recs.data(), n.data(), lane0.data(),
                                   (int)n_traces, kLaneB, kLaneBp, L,
                                   pk.data(), p1.data(), bitw.data(),
                                   lens.data());
  bool ok = form >= 0;
  for (size_t i = 0; ok && i < n_traces; i++)
    for (int64_t r = lane0[i], j = 0; ok && j * kLaneB < std::max<int64_t>(n[i], 1);
         r++, j++) {
      const int cnt = (int)std::min<int64_t>(kLaneB, n[i] - j * kLaneB);
      ok = lens[r] == cnt &&
           row_ok(recs[i] + j * kLaneB, cnt, form, &pk[r * 3 * kLaneBp / 2],
                  &p1[r * kLaneBp], &bitw[r * kLaneBp / 32]);
    }
  avtpu_xclose(h);
  *rows += L;
  return ok;
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> base(n);
  if (fread(base.data(), 1, n, f) != (size_t)n) return 2;
  fclose(f);
  rng_state = strtoull(argv[2], nullptr, 10) | 1;
  int trials = atoi(argv[3]);

  uint8_t* out;
  size_t cn = avtpu_compress_mt(base.data(), n, kScopeGop, 1, &out);
  std::vector<uint8_t> container(out, out + cn);
  avtpu_free(out);
  const std::vector<size_t> lists = riff_lists(base);

  long decoded = 0, compressed = 0, in_lists = 0, rows = 0;
  for (int t = 0; t < trials; t++) {
    std::vector<uint8_t> blob = container;
    switch (xrnd() % 3) {
      case 0:
        for (uint32_t k = 0, m = 1 + xrnd() % 8; k < m; k++)
          blob[xrnd() % blob.size()] ^= 1 << (xrnd() % 8);
        break;
      case 1:
        blob.resize(xrnd() % blob.size());
        break;
      default: {
        size_t i = xrnd() % blob.size();
        for (size_t k = i; k < blob.size() && k < i + 16; k++)
          blob[k] = (uint8_t)xrnd();
      }
    }
    uint8_t* o = nullptr;
    if (avtpu_decompress_mt(blob.data(), blob.size(), 1, &o)) {
      decoded++;
      avtpu_free(o);
    }

    std::vector<uint8_t> vid = base;
    if (!lists.empty() && xrnd() % 2) {  // a chunk header of the RIFF tree
      const size_t at = lists[xrnd() % lists.size()] + xrnd() % 12;
      vid[at] ^= 1 << (xrnd() % 8);
      in_lists++;
    } else {
      for (uint32_t k = 0, m = 1 + xrnd() % 8; k < m; k++)
        vid[xrnd() % vid.size()] ^= 1 << (xrnd() % 8);
    }
    o = nullptr;
    size_t cm = avtpu_compress_mt(vid.data(), vid.size(), kScopeGop, 1, &o);
    if (cm) {
      // whatever compressed must decompress back to the mutated input
      compressed++;
      uint8_t* d = nullptr;
      size_t dn = avtpu_decompress_mt(o, cm, 1, &d);
      if (dn != vid.size() || memcmp(d, vid.data(), dn) != 0) {
        fprintf(stderr, "ROUNDTRIP MISMATCH on mutated input, trial %d\n", t);
        return 1;
      }
      avtpu_free(d);
      avtpu_free(o);
    }
    if (!extract_and_pack(vid, &rows)) {
      fprintf(stderr, "LANE PACK MISMATCH on mutated input, trial %d\n", t);
      return 1;
    }
  }
  printf("trials=%d containers_decoded=%ld inputs_compressed=%ld "
         "list_header_mutants=%ld lane_rows=%ld\n",
         trials, decoded, compressed, in_lists, rows);
  printf("FUZZ_OK\n");
  return 0;
}
