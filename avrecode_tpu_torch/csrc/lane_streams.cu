// Lane-parallel range encoder with the finalize fused in, for Hopper (sm_90a).
//
// Replaces avrecode_tpu/ops/lane_coder.py::_lane_pipeline_jit, which runs
// the Pallas kernel _lane_kernel and the XLA program _finalize_device in one
// jitted call: from the compact device upload straight to every lane's
// resolved stream bytes.  The [L, Bp] tokens and carry counts (8 B a bin)
// that lane_encode.cu stores and a finalize reads back never exist here.
//
//   p1     uint16 [L, Bp]       exact per-bin model probability of a 1
//                               (Bp a multiple of 32, base 16-byte aligned)
//          or, for lane_encode_streams_idx_launch (the index form, which
//          replaces _lane_pipeline_idx_jit), uint8 [L, 3 * Bp / 2]: two
//          12-bit indices into the 4,096-entry squash table `sq` (uint16)
//          in three bytes, the even bin's in the low 12 bits; a bin's p1 is
//          sq[index]
//   bitw   int32  [L, Bp / 32]  the bins' bits, little-endian 32-bit words
//   lens   int32  [L]           valid bins per lane (bins past it are frozen)
//   out    uint8  [L, M]        the lane's stream bytes (M a multiple of 8);
//                               bytes at and past nbytes are unspecified
//   nbytes int32  [L]           length of the lane's stream
//   total  int32  [L]           bytes the lane emitted, the two flush bytes
//                               included; total > M: the lane ran past the
//                               bound, its out row and nbytes mean nothing
//
// Bounds on this card.  Bytes: 2 + 1/8 B read a bin (1.5 + 1/8 in the index
// form), at most M written a lane: 285 MB + 34 MB at [8192, 16384] with M =
// 4104, 0.095 ms at 3.35 TB/s (218 MB + 34 MB, 0.075 ms, in the index
// form).  Operations: the algorithm's 10 integer operations a bin and 10 a
// stream byte (chip_smoke.py's STREAM_OPS), 0.04 ms: the bytes bind.
// The floor that counts is the chain: a lane is one serial recurrence over
// (low, rng), so Bp bins cost Bp times one bin's dependent steps (~53
// cycles as lane_encode.cu codes them, 0.44 ms at 16,384 bins).  What a warp
// reaches is set by its own instruction stream: it issues in order, so a
// stall on the chain holds the side work behind it, and each integer
// instruction holds its scheduler's 16 integer lanes two cycles however many
// of its threads work.  One thread a lane doing everything (the earlier
// design, ~36 instructions a bin) ran at 98 cycles a bin, four warps alone
// on the card as slowly as 512.
//
// Design: two warps code a lane group of 32 lanes, every thread busy, and
// each lane's work is split between them; in the u16 form a block is one
// group, and each warp runs on a scheduler of its own (chip_latency.cu's
// `where` probe: the two warps of all 256 blocks of a full group land on
// different sub-partitions).
//   * The chain warp runs the (low, rng) recurrence, one thread a lane, over
//     128-bin tiles of p1 and bit words that it copies into shared memory
//     with cp.async a tile ahead (two buffers, a row padded by 16 bytes,
//     which also hold the row's four bit words).  The bit is folded into
//     the multipliers (p1 or -p1 for rng, 0 or p1 for low), chosen off the
//     chain, so rng_n and low_n are one multiply-add each: the subtract and
//     the select leave the chain.  Both renorm shifts come from one
//     find-leading-bit.  The pending-carry count is not kept here: for
//     each bin the warp hands over one 32-bit record, the two bytes a
//     renorm would emit (low's top two bytes), the carry out of low (0 or
//     1) and the number of bytes emitted (0, 1 or 2), 8 bins at a time as
//     two 16-byte stores into a record tile of 32 rows (rows padded by 16
//     bytes: conflict-free for both warps).  Two record tiles,
//     double-buffered: named barriers FULL and EMPTY a buffer let the chain
//     warp run up to two tiles ahead.  ~25 instructions a bin.
//   * The stream warp owns each lane's stream from the first byte to the
//     last.  A record's carry joins the pending count; a token that emits
//     takes the count along.  The newest byte is held in a register until
//     the next token's count has come: a record stores the held byte plus
//     the count at the position before the write position and its first
//     byte (with the count in bits 12-13, for the truncation rule) at the
//     write position, and the position moves on by the bytes emitted.
//     Selects by masks, no branch: ~21 instructions and two 16-bit stores a
//     record.  A lane's bytes not yet stored sit in a row of shared memory
//     that starts at the last stored piece, moved down after every tile, so
//     no position needs a mask.
//   * After a tile the stream warp settles the tile's new bytes: the
//     truncation cut (the last byte whose raw value is not 0xFF or whose
//     token held a carry; the backward scan goes on only past tokens
//     without a carry, so every byte it reads is raw), then the overflows,
//     found 8 elements a read: a final byte that was 0xFF and took a count
//     stands above 0xFF (one byte in a thousand); the thread takes the
//     excess off and ripples it base-256 toward lower positions, in shared
//     memory or, below the bytes still there, in pieces of global memory
//     stored after earlier tiles.  A carry into the byte before position 0
//     is dropped, as the reference drops it.
//   * Then the stream warp stores every lane's complete 8-byte pieces (two
//     threads a row, 8 elements packed to 8 bytes); the piece of the held
//     byte waits.  M is a multiple of 8: nothing is stored at or past it.
//   * After the last tile the chain warp hands over the flush (low rounded
//     up to a multiple of 2^24, and its carry) as one more record; the
//     stream warp appends its two bytes, settles them, stores the rest and
//     scans its resolved bytes backward from the cut for the last non-zero
//     one (a running "last non-zero" would be wrong: a ripple turns 0xFF
//     into 0x00).
//   * A lane group codes only as many tiles as its longest lane has bins.
//   * The index form adds a producer warp to each lane group and leaves the
//     chain warp's coding as it is in the u16 form.  The producer copies
//     each tile of packed indices (192 bytes a row, 12 cp.async chunks) and
//     bit words into shared memory a tile ahead, looks every 12-bit field up
//     in the squash table (8 KB of static shared memory, copied in by the
//     block at its start; a field is taken out as a byte offset, so a lookup
//     is one load) and writes the u16 form's p1 tile, which the chain warp
//     reads as it reads an uploaded one.  16 threads work along a row, 8
//     bins each, so that neighbouring threads read neighbouring 12-byte
//     groups and store neighbouring 16-byte chunks: no bank conflict (one
//     thread a row, the first design, read three words at a time from rows
//     52 words apart: 4 ways).  A thread's 8 lookups a step are the burst:
//     the shared memory serves the whole SM, and when a producer fired 32
//     lookups at once the chain warp's own loads and stores queued behind
//     them (the full group 0.61-0.62 ms against 0.57-0.58).  The stream
//     warp's record loads run one step ahead.  Hand-over: named barrier
//     P1FULL + b (tile b written), and P1EMPTY + b (coded) as an mbarrier,
//     which only the producer waits on.
//   * Where the index form's warps run: a block is one lane group (4 warps)
//     where every group gets an SM of its own, else two (8 warps, 64 lanes;
//     132 SMs hold 8,448 lanes, a full group in one wave).  Its shared
//     memory, 175,136 bytes, keeps it alone on its SM, so warp w lands on
//     scheduler w % 4 (chip_latency.cu's `where`): the chain warps have a
//     scheduler each to themselves, the producer shares one with its
//     group's stream warp, or with none in a one-group block.  Every
//     instruction another warp issues on a chain warp's scheduler slows the
//     chain (~1.1-1.8 cycles a bin for each instruction a bin); the earlier
//     block of three warps for 32 lanes, two blocks an SM, put one chain warp
//     of each SM beside the other block's producer.
// Tried on the way ([8192, 16384]; the one-thread design 0.795-0.814 ms in
// the same calls): the same split with the record carrying the count and
// the stream warp's held-byte select written as nested conditionals, which
// the compiler turned into a branch a record, 0.945-0.956 ms; the counts
// stored beside their bytes and added after the tile, 1.057 ms, the pass
// after a tile 0.45 ms of it (one token in ten carries, and a warp walks
// its 32 lanes' carries one after another); held byte and masks with the
// subtract and select still on the chain, 0.627-0.635 ms.
//
// The index form, tried on the way ([8192, 16384]; the u16 form 0.595-0.599
// ms in the same call): the chain warp unpacking as it loads, three word
// loads, eight fields and eight table loads for 8 bins on the chain warp,
// 0.716-0.724 ms; the stream warp writing the p1 tile a tile ahead,
// 0.848-0.849 (it then sets the pace); a producer warp in a block of three
// warps for 32 lanes, 0.621-0.623, and 0.531 against 0.562-0.566 with 55
// lanes, where no scheduler is shared.  Then, against that producer's
// 0.62-0.64 in the same calls: two groups a block with the producer beside
// the stream warp, 16 threads a row and four rows (32 lookups a thread) at
// once, 0.610-0.621; the producer split over two warps, one beside each of
// a group's warps, 0.605-0.621; the whole producer beside the chain warp,
// 0.613-0.625; 32 bins a thread, 8 at a time, 0.575-0.590 (its word loads
// meet 4-way conflicts); the stream warp's loads not ahead, 0.597-0.622;
// the chain warp's p1 loads one step ahead too, ~1.4 cycles a bin slower.
//
// Two switches take a piece out, for chip_variants.py to time what it costs
// (the output is then wrong): -DSTREAMS_NO_SETTLE skips the pass after a
// tile, -DSTREAMS_NO_STORES the two stores of a record.  All times are of
// sources run by chip_variants.py on an NVIDIA H100 80GB HBM3 at 700 W.

#include <cstdint>
#include <cuda_runtime.h>

#include "squash_idx.cuh"

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRows = 32;                     // lanes a lane group
constexpr int kThreads = 2 * kRows;           // its chain and stream warp
constexpr int kTileBins = 128;                // bins a lane, per tile
constexpr int kP1Row = kTileBins * 2 + 16;    // bytes: p1, then bit words
constexpr int kP1Tile = kRows * kP1Row;       // 8,704
constexpr int kRecRow = kTileBins * 4 + 16;   // bytes: a record a bin, padded
constexpr int kRecTile = kRows * kRecRow;     // 16,896
constexpr int kPiece = 8;                     // bytes of one global store
// A lane's bytes not yet stored, from position `stored` (a multiple of 8)
// on: at most 8 at the top of a tile, 256 more in it, two of the flush; a
// row starts 8 elements in, so that the element before position `stored`
// is the row's own, and is padded so that 8 rows at one index hit
// different banks.
constexpr int kUnsent = 272;
constexpr int kUnsentRow = 8 + kUnsent + 16;      // elements
constexpr int kUnsentTile = kRows * kUnsentRow * 2;     // 18,944 bytes
constexpr int kSmemBytes = 2 * kP1Tile + 2 * kRecTile + kUnsentTile;  // 70,144
// the index form's block: at most two lane groups (see the kernel); the
// squash table in static shared memory, then two mbarriers a group and each
// group's u16 form's buffers and two tiles of packed indices, the rows 192
// bytes apart with no padding (two rows are 96 words: 32 threads reading a
// word each at 12-byte steps hit 32 banks), then the rows' bit words
constexpr int kGroups = 2;  // at most, a block
constexpr int kSquashBytes = 4096 * 2;
constexpr int kBarBytes = kGroups * 2 * 8;  // a group's two P1EMPTY mbarriers
constexpr int kRawRow = kTileBins * 3 / 2;                 // 192
constexpr int kRawBits = kRows * kRawRow;                  // 6,144
constexpr int kRawTile = kRawBits + kRows * 16;            // 6,656
constexpr int kIdxGroupBytes = kSmemBytes + 2 * kRawTile;  // 83,456
constexpr int kIdxDynBytes = kBarBytes + kGroups * kIdxGroupBytes;  // 166,944

constexpr uint32_t kValue = 0x3FFu;  // an element's byte, with its excess
constexpr int kCountShift = 12;      // the token's carry count above it

// a lane group's named barriers of two warps, from its base id on (1, and 7
// for the index form's second group): FULL + b (records of buffer b
// written) and EMPTY + b (read), between the chain and the stream warp; in
// the index form P1FULL + b (p1 tile b written), between the producer and
// the chain warp
constexpr int kBarFull = 0;
constexpr int kBarEmpty = 2;
constexpr int kBarP1Full = 4;
constexpr int kBarIds = 6;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// The index form's P1EMPTY + b (p1 tile b coded): an mbarrier in shared
// memory, since two groups' four named barriers each would need 16 ids and
// a block has 15 besides __syncthreads'.  The chain warp arrives (release),
// the producer waits (acquire); use k of a buffer completes phase k, of
// parity k & 1.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

struct ChainState {
  uint32_t low, rng;
};

struct StreamState {
  int pos;        // bytes emitted so far = where the next byte goes
  uint32_t pend;  // carries out of low since the last byte was emitted
  uint32_t held;  // the element at pos - 1: it may still take a count
};

// A bin's record: byte 0 the second byte a renorm would emit, byte 1 the
// carry out of low (0 or 1), byte 2 the first byte, byte 3 the bytes
// emitted (0-2).  The flush's has the same layout.
__device__ __forceinline__ uint32_t record(uint32_t low, uint32_t carry,
                                           uint32_t sh) {
  return __byte_perm(low, carry, 0x5342) + (sh << 21);
}

// 8 bins of one lane through the chain: p1 as four packed pairs, the bits in
// the low byte of `bits`; their 8 records go to `rec` (two 16-byte stores).
// kCheck: only the first n_live of them are valid, the others leave the
// state alone and give a zero record.  It computes what lane_encode.cu's
// code8 does, but for the pending-carry count, which the stream warp keeps.
template <bool kCheck>
__device__ __forceinline__ void code8(ChainState& st, const uint4 pv,
                                      uint32_t bits, int n_live, uint4* rec) {
  const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
  uint32_t r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r[k] = 0u;
    if (kCheck && k >= n_live) continue;
    const uint32_t p1 = (k & 1) ? pw[k >> 1] >> 16 : pw[k >> 1] & 0xFFFFu;
    const bool one = (bits & (1u << k)) != 0u;
    // the bit folded into the multipliers, off the chain: rng_n is r1 or
    // rng - r1, low_n low or low + r1 (r1 = (rng >> 16) * p1), each one
    // multiply-add
    const uint32_t t = st.rng >> 16;
    const uint32_t rng_n = t * (one ? p1 : 0u - p1) + (one ? 0u : st.rng);
    const uint32_t low_n = t * (one ? 0u : p1) + st.low;
    // both renorm byte shifts from one find-leading-bit (0, 8 or 16); p1 = 0
    // makes rng_n 0 and takes two shifts, as the plain version does (rng's
    // shift is then 24, which leaves 0 as well, one step less on the chain)
    uint32_t lz;
    asm("bfind.shiftamt.u32 %0, %1;" : "=r"(lz) : "r"(rng_n));
    const uint32_t sh = min(lz, 16u) & 24u;
    r[k] = record(low_n, low_n < st.low ? 1u : 0u, sh);
    st.low = low_n << sh;
    st.rng = rng_n << (lz & 24u);
  }
  rec[0] = make_uint4(r[0], r[1], r[2], r[3]);
  rec[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// One record into the lane's stream (unsent0 + p: the element of position p).
// The carry joins the pending count, which goes with the token's first byte
// when it emits one: the count is added to the held byte, the newest one
// before this token, which goes to the position before the write position,
// and the first byte, with its count above it for the truncation rule, to
// the write position; the byte that is now newest becomes the held one.  A
// record that emits nothing rewrites the held byte and an element past the
// stream.  Masks, not branches.
__device__ __forceinline__ void put(StreamState& s, uint32_t r,
                                    uint16_t* unsent0) {
  const uint32_t n = r >> 24;
  const uint32_t any = 0u - min(n, 1u);  // all ones where a byte was emitted
  const uint32_t two = 0u - (n >> 1);    // all ones where two were
  s.pend += __byte_perm(r, 0u, 0x4441);
  const uint32_t c = s.pend & any;
  s.pend -= c;
  const uint32_t e0 = __byte_perm(r, 0u, 0x4442) + (c << kCountShift);
  const uint32_t e1 = r & 0xFFu;
#ifndef STREAMS_NO_STORES
  uint16_t* q = unsent0 + s.pos;
  q[-1] = static_cast<uint16_t>(s.held + c);
  q[0] = static_cast<uint16_t>(e0);
#endif
  const uint32_t newest = (e1 & two) | (e0 & ~two);
  s.held = (newest & any) | (s.held & ~any);
  s.pos += static_cast<int>(n);
}

// Settle the bytes a lane emitted at positions [from, to); unsent[0] holds
// position `stored`, below which the bytes are in the lane's row of `out`.
// The one at to - 1 is the held byte, those below it are final.  Returns the
// truncation cut: the last of them whose raw byte is not 0xFF or whose token
// held a carry, or `cut` if there is none.  (The scan goes on only past
// tokens without a carry, so every byte it looks at is raw.)  Then takes the
// excess off every final byte that stands above 0xFF, from the byte that
// was held before these on, and ripples it base-256 toward lower positions:
// in shared memory, or in `out` below it (never at or past column M: such a
// lane is past the bound and its row means nothing).  A carry into the byte
// before position 0 is dropped, as the reference drops it.
__device__ __noinline__ int settle(uint16_t* unsent,
                                   volatile unsigned char* row, int from,
                                   int to, int stored, int M, int cut) {
  for (int j = to - 1; j >= from; --j) {
    const uint32_t e = unsent[j - stored];
    if ((e & kValue) != 0xFFu || (e >> kCountShift) != 0u) {
      cut = j;
      break;
    }
  }
  const int first = max(from - 1, 0);
  for (int g = (first - stored) & ~7; g < to - stored; g += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(unsent + g);
    if (((v.x | v.y | v.z | v.w) & 0x03000300u) == 0u) continue;
    for (int j = max(g, first - stored); j < min(g + 8, to - stored); ++j) {
      uint32_t carry = (unsent[j] & kValue) >> 8;
      unsent[j] &= 0xF0FFu;
      for (int i = j - 1 + stored; carry != 0u && i >= 0; --i) {
        if (i >= stored) {
          uint16_t* p = unsent + (i - stored);
          const uint32_t x = (*p & 0xFFu) + carry;
          *p = static_cast<uint16_t>((*p & 0xF000u) | (x & 0xFFu));
          carry = x >> 8;
        } else {
          if (i >= M) break;
          const uint32_t x = row[i] + carry;
          row[i] = static_cast<unsigned char>(x);
          carry = x >> 8;
        }
      }
    }
  }
  return cut;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The index form's producer warp: copies tiles of packed indices and bit
// words into shared memory (cp.async, a tile a commit group, empty groups
// past the last tile) and writes them out as the u16 form's p1 tiles.
struct Producer {
  const unsigned char* pk;  // packed index rows, 3 * Bp / 2 bytes each
  const unsigned char* sq;  // the squash table, in static shared memory
  const uint32_t* bitw;
  unsigned char* s_raw;
  unsigned char* s_p1;
  uint64_t* p1empty;  // the group's P1EMPTY + b
  int bar, tid, lane0, rows, nt, Bp;

  __device__ __forceinline__ void load(int t) const {
    if (t < nt) {
      const int b0 = t * kTileBins;
      const int tw = min(kTileBins, Bp - b0);  // Bp % 32 == 0
      unsigned char* buf = s_raw + (t & 1) * kRawTile;
      const int c = tid & 15;  // two rows a pass, 12 chunks a full tile
      if (c < tw * 3 / 32)
        for (int r = tid >> 4; r < rows; r += 2)
          cp_async16(buf + r * kRawRow + c * 16,
                     pk + static_cast<size_t>(lane0 + r) * Bp * 3 / 2 +
                         static_cast<size_t>(b0) * 3 / 2 + c * 16);
      if (tid < rows)
        for (int w = 0; w < tw / 32; ++w)
          cp_async4(buf + kRawBits + tid * 16 + w * 4,
                    bitw + static_cast<size_t>(lane0 + tid) * (Bp / 32) +
                        b0 / 32 + w);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // tile t, its copy landed (the group after it may be in flight), into p1
  // tile t & 1: 16 threads along a row, 8 bins (three words, eight lookups,
  // one 16-byte store) each, two rows a step; neighbouring threads read
  // neighbouring 12-byte groups and store neighbouring 16-byte chunks, so
  // neither meets a bank conflict; a thread a row moves the row's bit words
  __device__ __forceinline__ void convert(int t) const {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    const int tw = min(kTileBins, Bp - t * kTileBins);
    const unsigned char* raw = s_raw + (t & 1) * kRawTile;
    unsigned char* p1t = s_p1 + (t & 1) * kP1Tile;
    const int j = tid & 15;  // bins 8j to 8j + 7 of a row
    if (j < tw / 8) {
#pragma unroll 1
      for (int r = tid >> 4; r < rows; r += 2) {
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(raw + r * kRawRow + j * 12);
        *reinterpret_cast<uint4*>(p1t + r * kP1Row + j * 16) =
            unpack8_p1(w[0], w[1], w[2], sq);
      }
    }
    if (tid < rows)
      *reinterpret_cast<uint4*>(p1t + tid * kP1Row + kTileBins * 2) =
          *reinterpret_cast<const uint4*>(raw + kRawBits + tid * 16);
    __syncwarp();  // the raw buffer may be refilled
  }
};

// A producer warp's loop: tile t into p1 buffer t & 1 once the chain warp
// has coded tile t - 2 from it.
__device__ __forceinline__ void producer_warp(const Producer& prod) {
  if (prod.nt == 0) return;
  prod.load(0);
  prod.load(1);
  for (int t = 0; t < prod.nt; ++t) {
    if (t >= 2) mbar_wait(prod.p1empty + (t & 1), ((t >> 1) - 1) & 1);
    prod.convert(t);
    bar_arrive(prod.bar + kBarP1Full + (t & 1));
    prod.load(t + 2);
  }
}

// The chain warp: codes the group's lanes tile by tile and hands over a
// record a bin, then the flush.  kFed (the index form): the producer writes
// the p1 tiles (p1empty: the group's P1EMPTY mbarriers); else the chain
// warp copies them in itself.  bar: the group's first named barrier.
template <bool kFed>
__device__ __forceinline__ void chain_warp(
    const uint16_t* __restrict__ p1, const uint32_t* __restrict__ bitw,
    unsigned char* s_p1, unsigned char* s_rec, uint64_t* p1empty, int bar,
    int tid, int lane0, int rows, int n_valid, int nt, int Bp) {
  const bool owner = tid < rows;
  const int lane = lane0 + tid;

  // tile t of p1 -> buffer t & 1: 16-byte chunks, neighbouring threads on
  // neighbouring chunks of a lane's row; the bit words go into the 16 bytes
  // that pad the row
  auto load_tile = [&](int t) {
    const int b0 = t * kTileBins;
    const int cpr = min(kTileBins, Bp - b0) / 8;  // chunks a row (Bp % 32 == 0)
    unsigned char* buf = s_p1 + (t & 1) * kP1Tile;
    const int c = tid & 15;  // two rows a pass, 16 chunks each
    if (c < cpr)
      for (int r = tid >> 4; r < rows; r += 2)
        cp_async16(buf + r * kP1Row + c * 16,
                   p1 + static_cast<size_t>(lane0 + r) * Bp + b0 + c * 8);
    if (owner)
      for (int w = 0; w < cpr / 4; ++w)
        cp_async4(buf + tid * kP1Row + kTileBins * 2 + w * 4,
                  bitw + static_cast<size_t>(lane) * (Bp / 32) + b0 / 32 + w);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  ChainState st{0u, 0xFFFFFFFFu};
  if (!kFed && nt > 0) load_tile(0);
  for (int t = 0; t < nt; ++t) {
    if (kFed) {
      bar_sync(bar + kBarP1Full + (t & 1));
    } else if (t + 1 < nt) {
      load_tile(t + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();
    if (t >= 2) bar_sync(bar + kBarEmpty + (t & 1));  // the stream warp read t - 2

    const int b0 = t * kTileBins;
    const int tw = min(kTileBins, Bp - b0);  // bins of this tile
    const unsigned char* prow = s_p1 + (t & 1) * kP1Tile + tid * kP1Row;
    unsigned char* rrow = s_rec + (t & 1) * kRecTile + tid * kRecRow;
    for (int w = 0; owner && w < tw / 32 && b0 + w * 32 < n_valid; ++w) {
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(prow + kTileBins * 2 + w * 4);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int i = w * 32 + g * 8;  // bin inside the tile
        const uint4 pv = *reinterpret_cast<const uint4*>(prow + i * 2);
        uint4* rec = reinterpret_cast<uint4*>(rrow + i * 4);
        const int n_live = n_valid - (b0 + i);
        if (n_live >= 8)
          code8<false>(st, pv, word >> (g * 8), 8, rec);
        else
          code8<true>(st, pv, word >> (g * 8), n_live, rec);
      }
    }
    __syncwarp();  // before the next tile overwrites the p1 buffer
    bar_arrive(bar + kBarFull + (t & 1));
    if (kFed) mbar_arrive(p1empty + (t & 1));  // the producer may refill
  }

  // the flush as one more record, in the buffer of "tile" nt: low rounded
  // up to the next 2^24 multiple, then two byte shifts
  if (nt >= 2) bar_sync(bar + kBarEmpty + (nt & 1));
  if (owner) {
    const uint32_t low_r = (st.low + (kTop - 1)) & 0xFF000000u;
    *reinterpret_cast<uint32_t*>(s_rec + (nt & 1) * kRecTile + tid * kRecRow) =
        record(low_r, low_r < st.low ? 1u : 0u, 16u);
  }
  __syncwarp();
  bar_arrive(bar + kBarFull + (nt & 1));
}

// The stream warp: turns the records into each lane's resolved bytes in
// `out`, then writes nbytes and total.  kAhead (the index form, where the
// stream warp shares its scheduler with the producer): the record loads run
// one step ahead, so that a put never waits on one.
template <bool kAhead>
__device__ __forceinline__ void stream_warp(
    unsigned char* s_rec, uint16_t* s_unsent, unsigned char* out,
    int32_t* __restrict__ nbytes, int32_t* __restrict__ total, int bar,
    int tid, int lane0, int rows, int n_valid, int nt, int Bp, int M) {
  const bool owner = tid < rows;
  const int lane = lane0 + tid;
  StreamState s{0, 0u, 0u};
  int stored = 0;  // the lane's bytes below this are in global memory
  int cut = 0;     // where the truncation rule cuts the stream
  uint16_t* unsent = s_unsent + tid * kUnsentRow + 8;  // position `stored` on
  unsigned char* row = out + static_cast<size_t>(owner ? lane : lane0) * M;

  // the warp stores every lane's pieces from `stored` up to `upto` (both
  // multiples of 8), two threads a row, 16 rows a pass, nothing at or past
  // column M
  auto store_pieces = [&](int upto) {
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += 16) {
      const int r = r0 + (tid >> 1);
      const int from = __shfl_sync(kFull, stored, r);
      const int to = min(__shfl_sync(kFull, upto, r), M);
      if (r < rows) {
        const uint16_t* src = s_unsent + r * kUnsentRow + 8 - from;
        unsigned char* dst = out + static_cast<size_t>(lane0 + r) * M;
        for (int j = from + (tid & 1) * kPiece; j < to; j += 2 * kPiece) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + j);
          *reinterpret_cast<uint2*>(dst + j) = make_uint2(
              __byte_perm(v.x, v.y, 0x6420), __byte_perm(v.z, v.w, 0x6420));
        }
      }
    }
  };

  for (int t = 0; t < nt; ++t) {
    bar_sync(bar + kBarFull + (t & 1));
    const int b0 = t * kTileBins;
    const int tw = min(kTileBins, Bp - b0);  // bins of this tile
    const unsigned char* rrow = s_rec + (t & 1) * kRecTile + tid * kRecRow;
    uint16_t* unsent0 = unsent - stored;
    const int from = s.pos;
    uint4 r_next = kAhead ? *reinterpret_cast<const uint4*>(rrow)
                          : make_uint4(0, 0, 0, 0);
    for (int w = 0; owner && w < tw / 32 && b0 + w * 32 < n_valid; ++w) {
#pragma unroll
      for (int h = 0; h < 8; ++h) {  // 4 records a read
        const uint4 r =
            kAhead ? r_next
                   : *reinterpret_cast<const uint4*>(rrow + w * 128 + h * 16);
        if (kAhead)  // past the records in use, inside the row
          r_next =
              *reinterpret_cast<const uint4*>(rrow + w * 128 + h * 16 + 16);
        put(s, r.x, unsent0);
        put(s, r.y, unsent0);
        put(s, r.z, unsent0);
        put(s, r.w, unsent0);
      }
    }
    __syncwarp();
    if (t + 2 <= nt) bar_arrive(bar + kBarEmpty + (t & 1));  // the chain may refill
    if (s.pos != from) {
      unsent[s.pos - 1 - stored] = static_cast<uint16_t>(s.held);
#ifndef STREAMS_NO_SETTLE
      cut = settle(unsent, row, from, s.pos, stored, M, cut);
#endif
    }
    __syncwarp();
    // all final bytes, in whole pieces: not the piece of the held byte
    const int upto = max(s.pos - 1, 0) & ~(kPiece - 1);
    store_pieces(upto);
    __syncwarp();
    if (upto != stored) {  // the piece left moves to the row's start
      *reinterpret_cast<uint4*>(unsent) =
          *reinterpret_cast<const uint4*>(unsent + (upto - stored));
      stored = upto;
    }
  }

  bar_sync(bar + kBarFull + (nt & 1));
  if (owner) {
    // the flush record: two bytes, the pending count onto the held byte
    const int from = s.pos;
    put(s, *reinterpret_cast<const uint32_t*>(s_rec + (nt & 1) * kRecTile +
                                              tid * kRecRow),
        unsent - stored);
    unsent[s.pos - 1 - stored] = static_cast<uint16_t>(s.held);
    cut = settle(unsent, row, from, s.pos, stored, M, cut);
  }
  __syncwarp();
  // the last, partly filled piece too; what lies past the stream's end in
  // it is unspecified
  store_pieces((s.pos + kPiece - 1) & ~(kPiece - 1));
  __syncwarp();

  if (owner) {
    // truncation: the stream ends at the cut (exclusive), less its trailing
    // zeros, read from the resolved bytes the warp has just stored
    int nb = 0;
    if (s.pos <= M) {
      const volatile unsigned char* bytes = row;
      for (int j = cut - 1; j >= 0; --j)
        if (bytes[j] != 0) {
          nb = j + 1;
          break;
        }
    }
    nbytes[lane] = nb;
    total[lane] = s.pos;
  }
}

// A lane's bins past its length are never read; a group codes as many
// tiles as its longest lane has bins.
__device__ __forceinline__ int valid_bins(const int32_t* __restrict__ lens,
                                          int lane, bool owner, int Bp) {
  const int n = owner ? lens[lane] : 0;
  return n < 0 ? 0 : (n > Bp ? Bp : n);
}

__device__ __forceinline__ int tiles(int n_valid) {
  return (__reduce_max_sync(kFull, n_valid) + kTileBins - 1) / kTileBins;
}

// The u16 form: a block of two warps for one lane group, the chain warp and
// the stream warp, on two schedulers (two blocks an SM fill all four).
__global__ void __launch_bounds__(kThreads)
lane_encode_streams_kernel(const uint16_t* __restrict__ p1,
                           const uint32_t* __restrict__ bitw,
                           const int32_t* __restrict__ lens,
                           unsigned char* out, int32_t* __restrict__ nbytes,
                           int32_t* __restrict__ total, int L, int Bp, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_p1 = smem;                  // two p1 tiles
  unsigned char* s_rec = smem + 2 * kP1Tile;   // two record tiles
  uint16_t* s_unsent = reinterpret_cast<uint16_t*>(smem + 2 * kP1Tile +
                                                 2 * kRecTile);
  const int tid = threadIdx.x & 31;  // the lane's row in the block
  const int lane0 = blockIdx.x * kRows;
  const int rows = min(kRows, L - lane0);  // lanes this block owns
  const int n_valid = valid_bins(lens, lane0 + tid, tid < rows, Bp);
  const int nt = tiles(n_valid);
  if (threadIdx.x < 32)
    chain_warp<false>(p1, bitw, s_p1, s_rec, nullptr, 1, tid, lane0, rows,
                      n_valid, nt, Bp);
  else
    stream_warp<false>(s_rec, s_unsent, out, nbytes, total, 1, tid, lane0,
                       rows, n_valid, nt, Bp, M);
}

// The index form: a block of kG lane groups, 4 kG warps, one block an SM
// (its shared memory), so that warp w runs on scheduler w % 4.  Roles by
// warp index w: group w % kG; w / kG = 0 its chain warp, 1 its stream
// warp, 2 none (the warp helps copy the squash table in and leaves), 3 its
// producer.  kG = 2: the chain warps 0-1 each have a scheduler to
// themselves, and each producer (6-7) shares one with its group's stream
// warp (2-3); kG = 1: every warp is alone.  A group's warps hand records
// and p1 tiles over under named barriers 1-6 (group 0) or 7-12 (group 1),
// and the producer waits for a coded tile on the group's mbarriers.
template <int kG>
__global__ void __launch_bounds__(kG * 128)
lane_encode_streams_idx_kernel(const unsigned char* __restrict__ pk,
                               const uint16_t* __restrict__ sq,
                               const uint32_t* __restrict__ bitw,
                               const int32_t* __restrict__ lens,
                               unsigned char* out,
                               int32_t* __restrict__ nbytes,
                               int32_t* __restrict__ total, int L, int Bp,
                               int M) {
  __shared__ __align__(16) uint16_t s_sq[4096];
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);
  // the squash table, 16 bytes a thread and step
  for (int k = threadIdx.x; k < kSquashBytes / 16; k += kG * 128)
    reinterpret_cast<uint4*>(s_sq)[k] = reinterpret_cast<const uint4*>(sq)[k];
  // a group's P1EMPTY 0-1, each completed by the chain warp
  if (threadIdx.x < kG * 2) mbar_init(s_bar + threadIdx.x, 32);
  __syncthreads();

  const int warp = threadIdx.x >> 5, role = warp / kG, g = warp % kG;
  const int tid = threadIdx.x & 31;
  const int lane0 = (blockIdx.x * kG + g) * kRows;
  const int rows = min(kRows, L - lane0);  // lanes this group owns
  if (role == 2 || rows <= 0) return;      // the last block's second group
  const int n_valid = valid_bins(lens, lane0 + tid, tid < rows, Bp);
  const int nt = tiles(n_valid);
  unsigned char* s_p1 = smem + kBarBytes + g * kIdxGroupBytes;
  unsigned char* s_rec = s_p1 + 2 * kP1Tile;
  uint16_t* s_unsent = reinterpret_cast<uint16_t*>(s_rec + 2 * kRecTile);
  uint64_t* p1empty = s_bar + 2 * g;
  const int bar = 1 + kBarIds * g;
  if (role == 0)
    chain_warp<true>(nullptr, bitw, s_p1, s_rec, p1empty, bar, tid, lane0,
                     rows, n_valid, nt, Bp);
  else if (role == 1)
    stream_warp<true>(s_rec, s_unsent, out, nbytes, total, bar, tid, lane0,
                      rows, n_valid, nt, Bp, M);
  else
    producer_warp(Producer{pk, reinterpret_cast<const unsigned char*>(s_sq),
                           bitw, s_p1 + kSmemBytes, s_p1, p1empty, bar, tid,
                           lane0, rows, nt, Bp});
}

// kG = 1 asks for the same shared memory as kG = 2: one block an SM, every
// warp on a scheduler of its own.
template <int kG>
int launch_idx(const void* p1pk, const void* sq, const void* bitw,
               const void* lens, void* out, void* nbytes, void* total, int L,
               int Bp, int M, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lane_encode_streams_idx_kernel<kG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kIdxDynBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kLanes = kG * kRows;
  lane_encode_streams_idx_kernel<kG>
      <<<(L + kLanes - 1) / kLanes, kG * 128, kIdxDynBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const unsigned char*>(p1pk),
          static_cast<const uint16_t*>(sq), static_cast<const uint32_t*>(bitw),
          static_cast<const int32_t*>(lens), static_cast<unsigned char*>(out),
          static_cast<int32_t*>(nbytes), static_cast<int32_t*>(total), L, Bp,
          M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lane_encode_streams_launch(const void* p1, const void* bitw,
                                          const void* lens, void* out,
                                          void* nbytes, void* total, int L,
                                          int Bp, int M, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lane_encode_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_encode_streams_kernel<<<(L + kRows - 1) / kRows, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(p1), static_cast<const uint32_t*>(bitw),
      static_cast<const int32_t*>(lens), static_cast<unsigned char*>(out),
      static_cast<int32_t*>(nbytes), static_cast<int32_t*>(total), L, Bp, M);
  return static_cast<int>(cudaGetLastError());
}

// p1pk: uint8 [L, 3 * Bp / 2] packed squash indices (16-byte aligned); sq:
// the squash table, uint16 [4096] on the device (16-byte aligned).  One
// lane group a block where every group gets an SM of its own, else two.
extern "C" int lane_encode_streams_idx_launch(const void* p1pk, const void* sq,
                                              const void* bitw,
                                              const void* lens, void* out,
                                              void* nbytes, void* total,
                                              int L, int Bp, int M,
                                              void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return (L + kRows - 1) / kRows <= sms
             ? launch_idx<1>(p1pk, sq, bitw, lens, out, nbytes, total, L, Bp,
                             M, stream)
             : launch_idx<2>(p1pk, sq, bitw, lens, out, nbytes, total, L, Bp,
                             M, stream);
}
