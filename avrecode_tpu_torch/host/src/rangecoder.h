// Recoded-stream binary range coder — exact C++ mirror of ops/rangecoder.py
// (32-bit range, 16-bit probabilities, carry-counter byte emission).
#pragma once
#include <cstdint>
#include "bitio.h"

namespace avtpu {

constexpr uint32_t kTop = 1u << 24;

class RangeEncoder {
 public:
  void put(int bit, uint32_t p1) {
    uint32_t r1 = (range_ >> 16) * p1;
    if (bit) {
      range_ = r1;
    } else {
      low_ += r1;
      range_ -= r1;
    }
    while (range_ < kTop) {
      range_ <<= 8;
      shift_low();
    }
  }

  Bytes finish() {
    // Shortest terminator (mirror of rangecoder.py): round low up to the
    // next 2^24 multiple (in range: renorm keeps range >= 2^24), emit the
    // carry + the one revealed byte, strip redundant trailing zeros (the
    // decoder zero-fills past the end).
    low_ = (low_ + (kTop - 1)) & ~(uint64_t)(kTop - 1);
    shift_low();
    shift_low();
    // out_[0] is the dummy integer-position byte (always 0): drop it.
    size_t end = out_.size();
    while (end > 1 && out_[end - 1] == 0) end--;
    return Bytes(out_.begin() + 1, out_.begin() + end);
  }
  size_t out_size() const { return out_.size(); }

  void save(uint64_t* low, uint32_t* range, uint8_t* cache,
            uint64_t* cache_size, size_t* out_len) const {
    *low = low_;
    *range = range_;
    *cache = cache_;
    *cache_size = cache_size_;
    *out_len = out_.size();
  }
  void restore(uint64_t low, uint32_t range, uint8_t cache,
               uint64_t cache_size, size_t out_len) {
    low_ = low;
    range_ = range;
    cache_ = cache;
    cache_size_ = cache_size;
    out_.resize(out_len);
  }

 private:
  void shift_low() {
    if (low_ < 0xFF000000ull || low_ > 0xFFFFFFFFull) {
      uint8_t carry = (uint8_t)(low_ >> 32);
      if (cache_size_) {
        out_.push_back((uint8_t)(cache_ + carry));
        for (uint64_t i = 1; i < cache_size_; i++)
          out_.push_back((uint8_t)(0xFF + carry));
      }
      cache_ = (uint8_t)(low_ >> 24);
      cache_size_ = 0;
    }
    cache_size_++;
    low_ = (low_ << 8) & 0xFFFFFFFFull;
  }

  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint8_t cache_ = 0;
  uint64_t cache_size_ = 1;  // dummy integer-position byte
  Bytes out_;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t* data, size_t size) : data_(data), size_(size) {
    for (int i = 0; i < 4; i++) code_ = (code_ << 8) | next_byte();
  }

  int get(uint32_t p1) {
    uint32_t r1 = (range_ >> 16) * p1;
    int bit;
    if (code_ < r1) {
      bit = 1;
      range_ = r1;
    } else {
      bit = 0;
      code_ -= r1;
      range_ -= r1;
    }
    while (range_ < kTop) {
      range_ <<= 8;
      code_ = (code_ << 8) | next_byte();
    }
    return bit;
  }

 private:
  uint8_t next_byte() {
    uint8_t b = pos_ < size_ ? data_[pos_] : 0;  // zeros past end
    pos_++;
    return b;
  }
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint32_t code_ = 0;
};

}  // namespace avtpu
