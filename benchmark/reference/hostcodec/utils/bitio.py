"""MSB-first bit reader/writer with Exp-Golomb, plus RBSP (un)escaping.

Host-side byte twiddling for NAL/slice-header parsing.  The reference gets
all of this from ffmpeg internals (SURVEY.md L0); here it is owned code.
"""


class BitReader:
    def __init__(self, data, bitpos=0):
        self.data = data
        self.bitpos = bitpos

    def u(self, n):
        """Read n bits as unsigned (MSB first)."""
        v = 0
        for _ in range(n):
            byte_i = self.bitpos >> 3
            if byte_i >= len(self.data):
                raise EOFError("bit read past end of RBSP")
            v = (v << 1) | ((self.data[byte_i] >> (7 - (self.bitpos & 7))) & 1)
            self.bitpos += 1
        return v

    def flag(self):
        return self.u(1)

    def ue(self):
        """Unsigned Exp-Golomb (clause 9.1)."""
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid exp-golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self):
        """Signed Exp-Golomb (clause 9.1.1)."""
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def byte_aligned(self):
        return (self.bitpos & 7) == 0

    def more_rbsp_data(self):
        """Clause 7.2: true if there is data before rbsp_stop_one_bit."""
        total_bits = len(self.data) * 8
        if self.bitpos >= total_bits:
            return False
        # find last set bit in the stream (the stop bit)
        i = len(self.data) - 1
        while i >= 0 and self.data[i] == 0:
            i -= 1
        if i < 0:
            return False
        b = self.data[i]
        stop_bitpos = i * 8 + 7
        while not (b & 1):
            b >>= 1
            stop_bitpos -= 1
        return self.bitpos < stop_bitpos


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self._buf = 0
        self._cnt = 0

    def u(self, value, n):
        for i in range(n - 1, -1, -1):
            self._buf = (self._buf << 1) | ((value >> i) & 1)
            self._cnt += 1
            if self._cnt == 8:
                self.out.append(self._buf)
                self._buf = 0
                self._cnt = 0

    def ue(self, value):
        value += 1
        nbits = value.bit_length()
        self.u(0, nbits - 1)
        self.u(value, nbits)

    def se(self, value):
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_with(self, bit):
        while self._cnt != 0:
            self.u(bit, 1)

    @property
    def bitpos(self):
        return len(self.out) * 8 + self._cnt

    def bytes(self):
        assert self._cnt == 0, "unaligned bit writer"
        return bytes(self.out)


def unescape_rbsp(data):
    """Remove emulation_prevention_three_bytes (clause 7.3.1 / 7.4.1.1)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        if i + 2 < n and data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 3:
            out.append(0)
            out.append(0)
            i += 3
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def escape_rbsp(rbsp):
    """Insert emulation_prevention_three_bytes (canonical encoder escaping).

    After two zero bytes, any byte <= 3 forces an escape.  All conformant
    encoders use exactly this minimal rule, so escape(unescape(x)) == x for
    conformant x — verified per NAL by the compressor, with raw fallback
    otherwise (the reference instead skips such blocks, recode.cpp:1296-1303).
    """
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)
