"""Recoded-stream binary range coder (exact-integer reference implementation).

This is the successor of the reference's generic arithmetic coder
(arithmetic_code.h:85-298) but is a different, TPU-friendly design: a 32-bit
binary range coder with 16-bit probabilities and byte-wise renormalization
using cache+carry-run emission (the classic carry-counter scheme) instead of
the reference's deferred-digit overflow buffer (arithmetic_code.h:147-180).

All state fits in a few uint32/uint64 registers with pure integer ops, so the
identical recurrence runs as:
  * this pure-Python reference (tests / oracle)
  * the C++ host hot path (host/src/rangecoder.h)
  * the lane-parallel Pallas kernel (ops/pallas_coder.py)
and all three are bit-identical by construction.

Probability convention: `p1` is the probability that the NEXT symbol is 1,
as a 16-bit integer in [1, 0xFFFF].  The split is
    r1 = (range >> 16) * p1         (range is kept in [2^24, 2^32))
so r1 >= 1 and range - r1 >= 1 always hold for p1 in [1, 0xFFFF].

Termination: `finish()` picks the SHORTEST terminating value (the analog of
arithmetic_code.h:128-144): low is rounded up to the next multiple of 2^24
(always inside [low, low+range) because renormalization keeps range >= 2^24),
so at most one fractional byte is revealed, and trailing zero bytes are
stripped (the decoder zero-fills past the end).  Typical stream tail is 1-2
bytes instead of the naive 5-byte register flush.
"""

TOP = 1 << 24
MASK32 = 0xFFFFFFFF
PROB_BITS = 16
PROB_ONE = 1 << PROB_BITS


class RangeEncoder:
    """Binary range encoder. put(bit, p1) appends one symbol."""

    def __init__(self):
        self.low = 0  # up to 33 bits of pending low (carry in bit 32)
        self.range = MASK32
        self.cache = 0  # last byte not yet emitted (may be incremented by carry)
        # Pending bytes represented by cache + a 0xFF run.  Starts at 1: the
        # initial dummy cache byte absorbs a (provably impossible, see finish)
        # carry out of the integer position and is dropped from the output.
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        # Emit one byte of `low`, resolving carries into the cached byte run.
        if self.low < 0xFF000000 or self.low > MASK32:
            carry = self.low >> 32
            if self.cache_size:
                self.out.append((self.cache + carry) & 0xFF)
                # the 0xFF run becomes 0x00 on carry
                self.out.extend(((0xFF + carry) & 0xFF,) * (self.cache_size - 1))
            self.cache = (self.low >> 24) & 0xFF
            self.cache_size = 0
        self.cache_size += 1
        self.low = (self.low << 8) & MASK32

    def put(self, bit, p1):
        """Encode one binary symbol with P(bit==1) = p1 / 2^16."""
        assert 0 < p1 < PROB_ONE
        r1 = (self.range >> PROB_BITS) * p1
        if bit:
            self.range = r1
        else:
            self.low += r1
            self.range -= r1
        while self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self._shift_low()

    def finish(self):
        # Shortest terminator: round low up to the next 2^24 multiple — in
        # range because put() renormalizes to range >= 2^24 — revealing at
        # most one fractional byte (plus a possible carry into the cache).
        assert self.range >= TOP
        self.low = (self.low + (TOP - 1)) & ~(TOP - 1)
        # Two shifts: the first resolves the round-up carry into the cached
        # byte run, the second emits the revealed byte itself.
        self._shift_low()
        self._shift_low()
        # out[0] is the dummy integer-position byte.  The coder maintains
        # low + range <= 2^32 (scaled), so the cumulative value never carries
        # out of the fractional window and out[0] is always 0: drop it.
        assert self.out[0] == 0
        out = bytes(self.out[1:])
        # the decoder zero-fills past the end: trailing zeros are redundant
        return out.rstrip(b"\x00")


class RangeDecoder:
    """Mirror of RangeEncoder. get(p1) returns the next symbol."""

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.range = MASK32
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & MASK32

    def _byte(self):
        # Reading past the end yields zeros, mirroring arithmetic_code.h:283-285.
        if self.pos < len(self.data):
            b = self.data[self.pos]
        else:
            b = 0
        self.pos += 1
        return b

    def get(self, p1):
        assert 0 < p1 < PROB_ONE
        r1 = (self.range >> PROB_BITS) * p1
        if self.code < r1:
            bit = 1
            self.range = r1
        else:
            bit = 0
            self.code -= r1
            self.range -= r1
        while self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self.code = ((self.code << 8) | self._byte()) & MASK32
        return bit
