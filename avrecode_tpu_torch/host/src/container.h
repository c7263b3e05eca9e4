// AVTR recoded container — C++ mirror of utils/container.py.
#pragma once
#include <cstdint>
#include <cstring>
#include "bitio.h"

namespace avtpu {

constexpr uint8_t kVersion = 12;  // v12: CAVLC slice blocks (model v10)
enum { KIND_LITERAL = 0, KIND_SLICE = 1, KIND_END = 2 };
enum { SCOPE_STREAM = 0, SCOPE_SLICE = 1, SCOPE_GOP = 2 };

struct CWriter {
  Bytes out;
  void u8(uint8_t v) { out.push_back(v); }
  void u16(uint16_t v) {
    out.push_back(v & 0xFF);
    out.push_back(v >> 8);
  }
  void varint(uint64_t v) {
    for (;;) {
      uint8_t b = v & 0x7F;
      v >>= 7;
      if (v) {
        out.push_back(b | 0x80);
      } else {
        out.push_back(b);
        return;
      }
    }
  }
  void blob(const uint8_t* d, size_t n) {
    varint(n);
    out.insert(out.end(), d, d + n);
  }
  void blob(const Bytes& b) { blob(b.data(), b.size()); }
};

struct CReader {
  const uint8_t* data;
  size_t size, pos = 0;
  uint8_t u8() {
    if (pos >= size) throw ParseError("container underrun");
    return data[pos++];
  }
  uint16_t u16() {
    uint16_t v = u8();
    return (uint16_t)(v | (u8() << 8));
  }
  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    for (;;) {
      uint8_t b = u8();
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
  }
  Bytes blob() {
    uint64_t n = varint();
    if (pos + n > size) throw ParseError("container blob underrun");
    Bytes b(data + pos, data + pos + n);
    pos += n;
    return b;
  }
};

}  // namespace avtpu
