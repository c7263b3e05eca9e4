"""Coder implementations driven by the slice parser.

CompressCoder  — bins decoded from the real CABAC payload; every bin is
                 simultaneously replayed into a verification CabacEncoder
                 (self-check: re-encoded bytes must be a prefix-match of the
                 original payload) and optionally fed to the recode model.
DecompressCoder— bins decoded from the recode model stream; every bin is fed
                 to a CabacEncoder that regenerates the original payload.

The model argument is duck-typed (see models/h264_model.py): it needs
put_bit/get_bit keyed by model key, and put_nnz/get_nnz for out-of-band
num_nonzeros.  model=None turns CompressCoder into a pure validation pass
(parse + byte-exact re-encode, no recoding).
"""


from ..ops.cabac import CABAC_P1, CabacDecoder, CabacEncoder, init_context_states
from .mbparse import ParseDesync


class CompressCoder:
    is_compress = True

    def __init__(self, payload, slice_qp, cabac_init_idc, model=None, verify=True):
        self.payload = payload
        self.dec = CabacDecoder(payload)
        self.states = init_context_states(slice_qp, cabac_init_idc)
        self.verify = verify
        if verify:
            self.vstates = init_context_states(slice_qp, cabac_init_idc)
            self.enc = CabacEncoder()
        self.model = model
        self.n_bins = 0
        # per-class original-CABAC bit ledger (the reference's "CABAC Bill",
        # recode.cpp:642-668): bits consumed from the payload per element
        self.cabac_bill = {}
        self._bill_anchor = self.dec.bitpos

    def _bill(self, cls):
        pos = self.dec.bitpos
        self.cabac_bill[cls] = self.cabac_bill.get(cls, 0) + (pos - self._bill_anchor)
        self._bill_anchor = pos

    # raw CABAC layer ----------------------------------------------------
    def cabac_raw_bin(self, ctx, cls="sig"):
        b = self.dec.decision(self.states, ctx)
        if self.verify:
            self.enc.decision(self.vstates, ctx, b)
        self.n_bins += 1
        self._bill(cls)
        return b

    def _raw_bypass(self):
        b = self.dec.bypass()
        if self.verify:
            self.enc.bypass(b)
        self.n_bins += 1
        return b

    def _raw_terminate(self):
        b = self.dec.terminate()
        if self.verify:
            self.enc.terminate(b)
        self.n_bins += 1
        self._bill("eos")
        return b

    def cabac_terminate_eos(self):
        # end_of_slice_flag: elided from the model stream (mb_count is
        # stored in the container instead — the C12 analog for terminates)
        return self._raw_terminate()

    def cabac_terminate_pcm(self):
        # mb_type I escape bin (ctx 276): modeled so decompression knows
        # whether the MB is I_PCM; the verify encoder's terminate(1) flush
        # byte-aligns the stream exactly where pcm samples begin
        b = self._raw_terminate()
        if self.model is not None:
            self.model.put_bit(("pcmf",), b)
        return b

    def pcm_samples(self, n):
        """I_PCM payload: n raw sample bytes at the byte boundary after the
        flushed terminate; both arithmetic engines re-initialize after them
        (9.3.1.2 — context states persist)."""
        assert self.verify, "pcm recoding requires the verify re-encoder"
        start = len(self.enc.out)
        raw = bytes(self.payload[start : start + n])
        if len(raw) < n:
            raise ParseDesync("pcm samples beyond payload")
        if self.model is not None:
            for byte in raw:
                for i in range(8):
                    self.model.put_bit(("pcm", i), (byte >> (7 - i)) & 1)
        self.enc.out += raw
        self.enc.reinit_arith()
        self.dec = CabacDecoder(self.payload, bit_offset=(start + n) * 8)
        self._bill_anchor = self.dec.bitpos
        return raw

    def cabac_p1(self, ctx):
        return int(CABAC_P1[self.states[ctx]])

    # modeled layer ------------------------------------------------------
    def coded_bin(self, ctx, mkey):
        pcab = int(CABAC_P1[self.states[ctx]])
        b = self.cabac_raw_bin(ctx, mkey[0])
        if self.model is not None:
            self.model.put_bit(mkey, b, pcab)
        return b

    def coded_bin_det(self, ctx, value):
        b = self.cabac_raw_bin(ctx, "det")
        if b != value:
            raise ParseDesync("deterministic decision bin mismatch")
        return b

    def bypass_bin(self, mkey):
        b = self._raw_bypass()
        self._bill(mkey[0])
        if self.model is not None:
            self.model.put_bit(mkey, b)
        return b

    def put_modeled(self, mkey, b, pcab=None):
        if self.model is not None:
            self.model.put_bit(mkey, b, pcab)

    def put_nnz(self, nnz, cat, max_coeff, prior, blk):
        if self.model is not None:
            self.model.put_nnz(nnz, cat, max_coeff, prior)

    # results ------------------------------------------------------------
    def reencoded(self):
        return self.enc.bytes() if self.verify else None

    def verify_tail(self):
        """Match re-encoded bytes against the original payload.

        Returns (ok, tail): ok=True when the re-encode reproduces the payload
        except possibly its final byte plus container-level trailing bytes —
        the generalization of the reference's last_byte/length_parity fields
        (recode.proto:16-17, recode.cpp:1291-1294): x264 flushes CABAC with a
        nonstandard `low|=1` terminator, so the final byte may differ from the
        spec flush, and encoders may append cabac_zero_words.  `tail` is the
        byte suffix of the original payload that must replace/extend the
        re-encode at decompress; it is stored in the container.
        """
        if not self.verify:
            return False, 0, b""
        out = self.enc.bytes()
        orig = self.payload
        n = min(len(out), len(orig))
        common = 0
        while common < n and out[common] == orig[common]:
            common += 1
        if common < len(out) - 1 or len(out) > len(orig):
            return False, 0, b""
        # drop: how many re-encoded suffix bytes the tail replaces (0 or 1)
        return True, len(out) - common, bytes(orig[common:])


class DecompressCoder:
    is_compress = False

    def __init__(self, slice_qp, cabac_init_idc, model):
        self.states = init_context_states(slice_qp, cabac_init_idc)
        self.enc = CabacEncoder()
        self.model = model

    # raw CABAC layer (re-encode) ---------------------------------------
    def cabac_raw_bin_put(self, ctx, b):
        self.enc.decision(self.states, ctx, b)

    def cabac_terminate_eos_put(self, b):
        self.enc.terminate(b)

    def cabac_terminate_pcm(self):
        b = self.model.get_bit(("pcmf",))
        self.enc.terminate(b)
        return b

    def pcm_samples(self, n):
        out = bytearray()
        for _ in range(n):
            v = 0
            for i in range(8):
                v = (v << 1) | self.model.get_bit(("pcm", i))
            out.append(v)
        self.enc.out += bytes(out)
        self.enc.reinit_arith()
        return bytes(out)

    def cabac_p1(self, ctx):
        return int(CABAC_P1[self.states[ctx]])

    # modeled layer ------------------------------------------------------
    def coded_bin(self, ctx, mkey):
        b = self.model.get_bit(mkey, int(CABAC_P1[self.states[ctx]]))
        self.enc.decision(self.states, ctx, b)
        return b

    def coded_bin_det(self, ctx, value):
        self.enc.decision(self.states, ctx, value)
        return value

    def bypass_bin(self, mkey):
        b = self.model.get_bit(mkey)
        self.enc.bypass(b)
        return b

    def get_modeled(self, mkey, pcab=None):
        return self.model.get_bit(mkey, pcab)

    def get_nnz(self, cat, max_coeff, prior, blk):
        return self.model.get_nnz(cat, max_coeff, prior)

    def payload(self):
        return self.enc.bytes()
