"""H.264 CABAC arithmetic engine — spec-exact (ITU-T H.264 clause 9.3).

Decoder (9.3.3.2) and encoder (9.3.4) implementing the standard decision,
bypass, and terminate codings plus context initialization (9.3.1.1).

The reference delegates CABAC *decoding* entirely to its patched ffmpeg
(cabac_code.h:84-85 is an empty stub; SURVEY.md C4/C18).  This framework
instead owns both directions, which is what makes the forward trace-extracting
parser (h264/) possible without a hooked decoder.

The encoder here plays the role of the reference's bit-exact CABAC re-encoder
(cabac_code.h:16-86): during decompression it must regenerate the original
slice payload byte-for-byte from the recoded bins.  Unlike cabac_code.h —
which wraps a generic coder with ffmpeg's range tables — this is the spec
algorithm itself (low/range/bitsOutstanding with PutBit), which is integer-
exact and directly portable to C++ and to lax.scan/Pallas form.

Context state convention: states are packed as  s = (pStateIdx << 1) | valMPS
in a flat numpy uint8 array indexed by ctxIdx, which is the dense-array
replacement for per-pointer context identity (SURVEY.md §3 hot loop #3).
"""

import numpy as np

from ._tables_data import (
    CTX_INIT_I,
    CTX_INIT_PB,
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
    TRANS_IDX_MPS,
)

NUM_CTX = 1024
CTX_TERMINATE = 276  # end_of_slice_flag / I_PCM escape context (no adaptation)

# P(bin == 1) per packed CABAC state, 16-bit: the standard CABAC state
# machine approximates p_LPS(sigma) = 0.5 * alpha^sigma with alpha ~ 0.9492.
# Used by the recode model as a mixing prior (the CABAC engine state is a
# free second predictor with qp-tuned initialization).
CABAC_P1 = np.zeros(128, dtype=np.uint16)
for _s in range(128):
    _sigma, _mps = _s >> 1, _s & 1
    _plps = int(round(65536 * 0.5 * (0.9492 ** _sigma)))
    _plps = max(32, min(32768, _plps))
    _p1 = 65536 - _plps if _mps else _plps
    CABAC_P1[_s] = max(1, min(0xFFFF, _p1))

_RANGE_TAB_LPS = np.asarray(RANGE_TAB_LPS, dtype=np.uint8)
_TRANS_MPS = np.asarray(TRANS_IDX_MPS, dtype=np.uint8)
_TRANS_LPS = np.asarray(TRANS_IDX_LPS, dtype=np.uint8)
_CTX_INIT_I = np.asarray(CTX_INIT_I, dtype=np.int32)
_CTX_INIT_PB = np.asarray(CTX_INIT_PB, dtype=np.int32)


def init_context_states(slice_qp, cabac_init_idc=None):
    """Clause 9.3.1.1: per-context (pStateIdx, valMPS) from (m, n) tables.

    cabac_init_idc=None selects the I/SI table; 0..2 select the P/B tables.
    Returns uint8 array of packed states (pStateIdx << 1) | valMPS.
    """
    tab = _CTX_INIT_I if cabac_init_idc is None else _CTX_INIT_PB[cabac_init_idc]
    m, n = tab[:, 0], tab[:, 1]
    qp = int(np.clip(slice_qp, 0, 51))
    pre = np.clip(((m * qp) >> 4) + n, 1, 126)
    mps = (pre > 63).astype(np.uint8)
    pstate = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.uint8)
    return ((pstate << 1) | mps).astype(np.uint8)


class CabacDecoder:
    """Spec 9.3.3.2 arithmetic decoding engine over an unescaped RBSP slice.

    Bits are consumed MSB-first from `data` starting at `bit_offset`.
    Reads past the end return 0 bits (decode of a valid stream never depends
    on them; they only feed renormalization slack).
    """

    def __init__(self, data, bit_offset=0):
        self.data = data
        self.bitpos = bit_offset
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self):
        byte_i = self.bitpos >> 3
        if byte_i < len(self.data):
            b = (self.data[byte_i] >> (7 - (self.bitpos & 7))) & 1
        else:
            b = 0
        self.bitpos += 1
        return b

    def decision(self, states, ctx):
        """DecodeDecision (9.3.3.2.1). Mutates packed state array in place."""
        s = states[ctx]
        pstate = s >> 1
        mps = s & 1
        r_lps = int(_RANGE_TAB_LPS[pstate, (self.range >> 6) & 3])
        self.range -= r_lps
        if self.offset >= self.range:
            bin_val = mps ^ 1
            self.offset -= self.range
            self.range = r_lps
            if pstate == 0:
                mps ^= 1
            states[ctx] = (_TRANS_LPS[pstate] << 1) | mps
        else:
            bin_val = mps
            states[ctx] = (_TRANS_MPS[pstate] << 1) | mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return int(bin_val)

    def bypass(self):
        """DecodeBypass (9.3.3.2.3)."""
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self):
        """DecodeTerminate (9.3.3.2.4). Returns 1 at end of slice."""
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0

    def consumed_bytes(self):
        """Bytes of input consumed so far (rounded up to whole bytes)."""
        return (self.bitpos + 7) >> 3


class CabacEncoder:
    """Spec 9.3.4 arithmetic encoding engine producing unescaped RBSP bytes.

    Used by decompression to regenerate the original CABAC payload from
    recoded bins (role of cabac_code.h:16-86 in the reference), and by the
    compressor's self-verification pass and the synthetic stream generator.
    """

    def __init__(self):
        self.low = 0
        self.range = 510
        self.first_bit_flag = True
        self.bits_outstanding = 0
        self.out = bytearray()
        self._bitbuf = 0
        self._bitcnt = 0

    # -- raw bit sink ----------------------------------------------------
    def _write_bit(self, b):
        self._bitbuf = (self._bitbuf << 1) | b
        self._bitcnt += 1
        if self._bitcnt == 8:
            self.out.append(self._bitbuf)
            self._bitbuf = 0
            self._bitcnt = 0

    def _put_bit(self, b):
        if self.first_bit_flag:
            self.first_bit_flag = False
        else:
            self._write_bit(b)
        while self.bits_outstanding > 0:
            self._write_bit(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put_bit(0)
            elif self.low >= 512:
                self.low -= 512
                self._put_bit(1)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # -- codings ---------------------------------------------------------
    def decision(self, states, ctx, bin_val):
        """EncodeDecision (9.3.4.2). Mutates packed state array in place."""
        s = states[ctx]
        pstate = s >> 1
        mps = s & 1
        r_lps = int(_RANGE_TAB_LPS[pstate, (self.range >> 6) & 3])
        self.range -= r_lps
        if bin_val != mps:
            self.low += self.range
            self.range = r_lps
            if pstate == 0:
                mps ^= 1
            states[ctx] = (_TRANS_LPS[pstate] << 1) | mps
        else:
            states[ctx] = (_TRANS_MPS[pstate] << 1) | mps
        self._renorm()

    def bypass(self, bin_val):
        """EncodeBypass (9.3.4.4)."""
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def terminate(self, bin_val):
        """EncodeTerminate (9.3.4.5); bin_val=1 flushes the engine."""
        self.range -= 2
        if bin_val:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self):
        """EncodeFlush (9.3.4.5.2) + byte alignment with zero bits.

        The flush ends with the rbsp_stop_one_bit baked into its final two
        written bits; remaining bits to the byte boundary are zero
        (rbsp_alignment_zero_bit), completing rbsp_slice_trailing_bits.
        """
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        # WriteBits(((codILow >> 7) & 3) | 1, 2)
        v = ((self.low >> 7) & 3) | 1
        self._write_bit((v >> 1) & 1)
        self._write_bit(v & 1)
        while self._bitcnt != 0:
            self._write_bit(0)

    def reinit_arith(self):
        """Re-initialize the arithmetic engine after I_PCM samples
        (9.3.1.2: context variables persist, the engine restarts).  Only
        legal at a byte boundary (the terminate-flush guarantees one)."""
        assert self._bitcnt == 0, "pcm reinit requires byte alignment"
        self.low = 0
        self.range = 510
        self.first_bit_flag = True
        self.bits_outstanding = 0

    def bytes(self):
        return bytes(self.out)
