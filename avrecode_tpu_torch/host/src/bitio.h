// Bit IO + Exp-Golomb + RBSP escaping — C++ mirror of utils/bitio.py.
#pragma once
#include <cstdint>
#include <cstddef>
#include <stdexcept>
#include <string>
#include <vector>

namespace avtpu {

using Bytes = std::vector<uint8_t>;

struct ParseError : std::runtime_error {
  explicit ParseError(const std::string& m) : std::runtime_error(m) {}
};
// Unsupported stream feature -> literal fallback (params.py UnsupportedStream).
struct Unsupported : ParseError {
  explicit Unsupported(const std::string& m) : ParseError(m) {}
};
// Deterministic-bin mismatch (mbparse.py ParseDesync).
struct Desync : ParseError {
  explicit Desync(const std::string& m) : ParseError(m) {}
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t bitpos = 0)
      : data_(data), size_(size), bitpos_(bitpos) {}

  uint32_t u(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
      size_t byte_i = bitpos_ >> 3;
      if (byte_i >= size_) throw ParseError("bit read past end of RBSP");
      v = (v << 1) | ((data_[byte_i] >> (7 - (bitpos_ & 7))) & 1);
      bitpos_++;
    }
    return v;
  }
  uint32_t flag() { return u(1); }

  uint32_t ue() {
    int zeros = 0;
    while (u(1) == 0) {
      if (++zeros > 32) throw ParseError("invalid exp-golomb code");
    }
    return (1u << zeros) - 1 + (zeros ? u(zeros) : 0);
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
  }
  bool byte_aligned() const { return (bitpos_ & 7) == 0; }

  bool more_rbsp_data() const {
    size_t total_bits = size_ * 8;
    if (bitpos_ >= total_bits) return false;
    ssize_t i = (ssize_t)size_ - 1;
    while (i >= 0 && data_[i] == 0) i--;
    if (i < 0) return false;
    uint8_t b = data_[i];
    size_t stop = i * 8 + 7;
    while (!(b & 1)) {
      b >>= 1;
      stop--;
    }
    return bitpos_ < stop;
  }

  size_t bitpos() const { return bitpos_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t bitpos_;
};

inline Bytes unescape_rbsp(const uint8_t* d, size_t n) {
  Bytes out;
  out.reserve(n);
  for (size_t i = 0; i < n;) {
    if (i + 2 < n && d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 3) {
      out.push_back(0);
      out.push_back(0);
      i += 3;
    } else {
      out.push_back(d[i++]);
    }
  }
  return out;
}

inline Bytes escape_rbsp(const uint8_t* d, size_t n) {
  Bytes out;
  out.reserve(n + n / 64);
  int zeros = 0;
  for (size_t i = 0; i < n; i++) {
    if (zeros >= 2 && d[i] <= 3) {
      out.push_back(3);
      zeros = 0;
    }
    out.push_back(d[i]);
    zeros = (d[i] == 0) ? zeros + 1 : 0;
  }
  return out;
}

}  // namespace avtpu
