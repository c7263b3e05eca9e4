"""H.264 CAVLC slice-data recoding (clauses 7.3.4/7.3.5, 9.1, 9.2).

The reference recodes ONLY CABAC entropy payloads (recode.cpp:149-167 — its
hooks fire from ffmpeg's CABAC decode path alone; CAVLC streams pass
through untouched), so this module EXCEEDS the reference's coverage:
baseline-profile streams (webcams, older encoders, `x264 --no-cabac`)
recompress instead of falling back to literal passthrough.

Design — bit-level modeling with element-class contexts:

Unlike CABAC (where re-encoding is a stateful arithmetic process that must
be verified byte-for-byte), CAVLC code words are fixed bit patterns, so
the recode can model the BITSTREAM BITS THEMSELVES: every bit the parser
consumes is entropy-coded through the adaptive model under a key
describing which syntax element (and which bit of it) is being read.
Decompression replays the identical parse with bits coming from the
model; since every bit is coded losslessly, the regenerated bitstream
equals the original BY CONSTRUCTION — the only possible failure is a
parse desync (wrong table, unsupported syntax), which compress detects
and turns into a literal fallback.  The parser is therefore written
direction-agnostically: one `bit(key)` primitive either reads-and-models
(compress) or model-decodes-and-writes (decompress); all higher-level
readers (ue/se/te, VLC trie walks, level prefix/suffix) are shared.

Compression leverage comes from the model: VLC codes waste fractions of
bits everywhere (that is why CABAC beats CAVLC by 5-15%), and the
logistic-mixing model with per-element-class keys, neighbor nC context
(folded into the coeff_token table selector), suffix-length-conditioned
level contexts, and zerosLeft-conditioned run contexts recovers that
slack adaptively.

Scope: progressive frame MBs, I/P/B slices, 4:2:0/4:2:2/4:4:4 (incl.
separate colour planes as monochrome pictures)/monochrome, 8x8
transform, I_PCM, any bit depth — 4:4:4 CAVLC matters because x264
LOSSLESS output defaults to High 4:4:4 Predictive with CAVLC.
MBAFF/PAFF and SP/SI CAVLC raise UnsupportedStream -> literal fallback.

Spec tables come from _cavlc_tables.py (generated by
tools/extract_cavlc_tables.py from the system libavcodec's named spec
constants — the same provenance as the CABAC tables).
"""

from ..utils.bitio import BitReader, BitWriter
from .params import UnsupportedStream
from .geometry import blk4_neighbor, chroma_blk_neighbor
from .mbparse import ParseDesync, _B_TYPE_INFO, _B_SUB_INFO, \
    PRED_L0, PRED_L1, PRED_BI, PRED_DIRECT
from .slicehdr import SLICE_B, SLICE_I, SLICE_P
from ._cavlc_tables import (
    CBP_INTER,
    CBP_INTER_MONO,
    CBP_INTRA,
    CBP_INTRA_MONO,
    COEFF_TOKEN,
    RUN_BEFORE,
    TOTAL_ZEROS,
    TOTAL_ZEROS_2x2,
    TOTAL_ZEROS_2x4,
)


def _decode_map(rows, valid):
    """{(length, bits): symbol} trie map from (bits, size) table rows.

    rows: list of rows of (bits, size); valid(r, i) -> symbol or None."""
    m = {}
    for r, row in enumerate(rows):
        for i, (bits, size) in enumerate(row):
            sym = valid(r, i)
            if sym is None or size == 0:
                continue
            m[(size, bits)] = sym
    return m


# coeff_token decode maps: symbol = (TotalCoeff, TrailingOnes)
_CT_MAPS = []
for _t, _tab in enumerate(COEFF_TOKEN):
    _rows = _tab

    def _valid(r, i, _t=_t):
        if i > min(3, r):
            return None
        if r == 0 and i > 0:
            return None
        return (r, i)

    _CT_MAPS.append(_decode_map(_rows, _valid))

# total_zeros maps per TotalCoeff: symbol = total_zeros
_TZ_MAPS = [_decode_map([TOTAL_ZEROS[tc - 1]],
                        lambda r, i, tc=tc: i if i <= 16 - tc else None)
            for tc in range(1, 16)]
_TZ22_MAPS = [_decode_map([TOTAL_ZEROS_2x2[tc - 1]],
                          lambda r, i, tc=tc: i if i <= 4 - tc else None)
              for tc in range(1, 4)]
_TZ24_MAPS = [_decode_map([TOTAL_ZEROS_2x4[tc - 1]],
                          lambda r, i, tc=tc: i if i <= 8 - tc else None)
              for tc in range(1, 8)]
# run_before maps per min(zerosLeft, 7): symbol = run
_RB_MAPS = [_decode_map([RUN_BEFORE[zl - 1]],
                        lambda r, i, zl=zl: i if i <= (zl if zl < 7 else 14)
                        else None)
            for zl in range(1, 8)]

_VLC_MAX = 20  # longest CAVLC code word is 16 bits; margin for desync

# Shipped key enrichments (A/B-measured on the CAVLC corpus, combined
# +0.74% of output): level prefix/suffix keyed on block category
# (luma/chroma-AC/DC differ in level statistics), run_before keyed on the
# coefficient index, mb_type keyed on neighbor intra-ness.  Measured and
# NOT shipped (recorded in ROADMAP.md): fine-nC coeff_token bucket
# (+0.04%), neighbor-cbp context (-0.03%), skip-run history (-0.01%).


class CavlcCompressCoder:
    """Reads the original bitstream, feeding every bit to the model."""

    is_compress = True

    def __init__(self, rbsp, start_bit, model=None):
        self.rbsp = rbsp
        self.r = BitReader(rbsp, start_bit)
        self.model = model
        self.n_bins = 0
        self.cabac_bill = {}
        # cache the rbsp stop-bit position for O(1) more_rbsp_data
        stop = -1
        for i in range(len(rbsp) - 1, -1, -1):
            if rbsp[i]:
                b = rbsp[i]
                stop = i * 8 + 7
                while not (b & 1):
                    b >>= 1
                    stop -= 1
                break
        self.stop_bitpos = stop

    def bit(self, key):
        b = self.r.u(1)
        if self.model is not None:
            self.model.put_bit(key, b, 0)
        self.n_bins += 1
        return b

    def more_data(self, done, mb_count):
        return self.r.bitpos < self.stop_bitpos

    def finish(self):
        """Verify canonical rbsp_slice_trailing_bits; return extra tail
        bytes (rare trailing zero bytes some encoders append)."""
        if self.r.u(1) != 1:
            raise ParseDesync("missing rbsp stop bit")
        while self.r.bitpos & 7:
            if self.r.u(1) != 0:
                raise ParseDesync("nonzero rbsp padding bit")
        return bytes(self.rbsp[self.r.bitpos >> 3:])


class CavlcDecompressCoder:
    """Model-decodes every bit and writes the regenerated bitstream."""

    is_compress = False

    def __init__(self, model, seed_val=0, seed_bits=0):
        self.w = BitWriter()
        if seed_bits:
            self.w.u(seed_val, seed_bits)
        self.model = model
        self.n_bins = 0

    def bit(self, key):
        b = self.model.get_bit(key, 0)
        self.w.u(b, 1)
        self.n_bins += 1
        return b

    def more_data(self, done, mb_count):
        return done < mb_count

    def finish(self):
        self.w.u(1, 1)  # rbsp_stop_one_bit
        while self.w.bitpos & 7:
            self.w.u(0, 1)
        return self.w.bytes()


class CavlcSliceParser:
    """Direction-agnostic CAVLC slice-data walk driving a CavlcCoder."""

    def __init__(self, sps, pps, header, pic, prev_pic, coder, slice_id,
                 isolate=False):
        if header.mbaff or header.field_pic:
            raise UnsupportedStream("CAVLC interlace")
        if header.slice_type not in (SLICE_I, SLICE_P, SLICE_B):
            raise UnsupportedStream("CAVLC SP/SI slice")

        self.sps = sps
        self.pps = pps
        self.hdr = header
        self.pic = pic
        self.c = coder
        self.sid = slice_id
        self.W = sps.pic_width_in_mbs
        self.H = sps.pic_height_in_map_units * \
            (1 if sps.frame_mbs_only_flag else 2)
        self.stype = header.slice_type
        self.ch422 = sps.chroma_format_idc == 2
        # 4:4:4 (non-separate): Cb/Cr parse as luma-style planes sharing
        # the luma cbp bits (clause 7.3.5.3 ChromaArrayType==3); separate
        # colour planes parse as monochrome pictures (ch400)
        self.ch444 = (sps.chroma_format_idc == 3
                      and not sps.separate_colour_plane_flag)
        self.ch400 = (sps.chroma_format_idc == 0
                      or bool(sps.separate_colour_plane_flag))
        self.ch_grid_h = 4 if self.ch422 else 2
        self.n_chroma_ac = 8 if self.ch422 else 4
        self.nref0 = header.num_ref_idx_l0_active
        self.nref1 = header.num_ref_idx_l1_active
        self.mbx = 0
        self.mby = 0
        self._mvd_b = 0

    # -- primitives ------------------------------------------------------
    def _ue(self, cls, a=0, cap=31):
        zeros = 0
        while self.c.bit((cls, a, 0, min(zeros, 15))) == 0:
            zeros += 1
            if zeros > cap:
                raise ParseDesync("ue overrun")
        v = 0
        for i in range(zeros):
            v = (v << 1) | self.c.bit((cls, a, 1, min(i, 15)))
        return (1 << zeros) - 1 + v

    def _se(self, cls, a=0):
        k = self._ue(cls, a)
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def _te(self, cls, a, cmax):
        if cmax == 0:
            return 0
        if cmax == 1:
            return 1 - self.c.bit((cls, a, 0, 0))
        v = self._ue(cls, a)
        if v > cmax:
            raise ParseDesync("te out of range")
        return v

    def _vlc(self, decmap, cls, a=0):
        val = 0
        for ln in range(1, _VLC_MAX + 1):
            val = (val << 1) | self.c.bit((cls, a, min(ln - 1, 15)))
            sym = decmap.get((ln, val))
            if sym is not None:
                return sym
        raise ParseDesync("vlc overrun")

    # -- availability / nC (9.2.1) ---------------------------------------
    def _avail(self, x, y):
        if x < 0 or y < 0 or x >= self.W or y >= self.H:
            return False
        return self.pic.slice_id[y, x] == self.sid

    def _nc_luma(self, blk, plane=0):
        nmap = (self.pic.nnz_luma if plane == 0
                else self.pic.nnz_c44[plane - 1])
        (lx, ly), lb = blk4_neighbor(self.mbx, self.mby, blk, -1, 0)
        (ux, uy), ub = blk4_neighbor(self.mbx, self.mby, blk, 0, -1)
        la = self._avail(lx, ly)
        ua = self._avail(ux, uy)
        na = int(nmap[ly, lx, lb]) if la else 0
        nb = int(nmap[uy, ux, ub]) if ua else 0
        if la and ua:
            return (na + nb + 1) >> 1
        return na if la else (nb if ua else 0)

    def _nc_chroma(self, comp, sub):
        (lx, ly), lb = chroma_blk_neighbor(self.mbx, self.mby, sub, -1, 0,
                                           self.ch_grid_h)
        (ux, uy), ub = chroma_blk_neighbor(self.mbx, self.mby, sub, 0, -1,
                                           self.ch_grid_h)
        la = self._avail(lx, ly)
        ua = self._avail(ux, uy)
        na = int(self.pic.nnz_chroma_ac[ly, lx, comp * 8 + lb]) if la else 0
        nb = int(self.pic.nnz_chroma_ac[uy, ux, comp * 8 + ub]) if ua else 0
        if la and ua:
            return (na + nb + 1) >> 1
        return na if la else (nb if ua else 0)

    # -- residual block (9.2) --------------------------------------------
    def residual_block(self, nc, max_coeff, cat=0):
        """Parse one CAVLC residual block; returns TotalCoeff."""
        if nc >= 8:
            tab = 3
        elif nc >= 4:
            tab = 2
        elif nc >= 2:
            tab = 1
        elif nc >= 0:
            tab = 0
        elif nc == -1:
            tab = 4
        else:
            tab = 5
        total, trailing = self._vlc(_CT_MAPS[tab], "vtok", tab)
        if total > max_coeff:
            raise ParseDesync("coeff_token exceeds block")
        for i in range(trailing):
            self.c.bit(("vt1", i))
        sl = 1 if (total > 10 and trailing < 3) else 0
        for i in range(total - trailing):
            prefix = 0
            while self.c.bit(("vlp", min(prefix, 15), sl, cat)) == 0:
                prefix += 1
                if prefix > 31:
                    raise ParseDesync("level_prefix overrun")
            suffix_size = sl
            if prefix == 14 and sl == 0:
                suffix_size = 4
            elif prefix >= 15:
                suffix_size = prefix - 3
            suffix = 0
            for j in range(suffix_size):
                suffix = (suffix << 1) | self.c.bit(
                    ("vls", min(j, 13), sl, cat))
            level_code = (min(15, prefix) << sl) + suffix
            if prefix >= 15 and sl == 0:
                level_code += 15
            if prefix >= 16:
                level_code += (1 << (prefix - 3)) - 4096
            if i == 0 and trailing < 3:
                level_code += 2
            abs_level = (level_code >> 1) + 1
            if sl == 0:
                sl = 1
            if abs_level > (3 << (sl - 1)) and sl < 6:
                sl += 1
        zeros = 0
        if total and total < max_coeff:
            if max_coeff == 4:
                zeros = self._vlc(_TZ22_MAPS[total - 1], "vtz", 16 + total)
            elif max_coeff == 8:
                zeros = self._vlc(_TZ24_MAPS[total - 1], "vtz", 20 + total)
            else:
                zeros = self._vlc(_TZ_MAPS[total - 1], "vtz", total)
            if zeros > max_coeff - total:
                raise ParseDesync("total_zeros exceeds block")
        zl = zeros
        for i in range(total - 1):
            if zl <= 0:
                break
            ra = min(zl, 7) + 8 * min(i, 3)
            run = self._vlc(_RB_MAPS[min(zl, 7) - 1], "vrun", ra)
            if run > zl:
                raise ParseDesync("run_before exceeds zerosLeft")
            zl -= run
        return total

    # -- macroblock layer (7.3.5) ----------------------------------------
    def _t8_inc(self):
        inc = 0
        if self._avail(self.mbx - 1, self.mby):
            inc += int(self.pic.t8x8[self.mby, self.mbx - 1])
        if self._avail(self.mbx, self.mby - 1):
            inc += int(self.pic.t8x8[self.mby - 1, self.mbx])
        return inc

    def _intra_pred_modes(self, n_blocks):
        for i in range(n_blocks):
            if not self.c.bit(("vipred", 0)):
                for j in range(3):
                    self.c.bit(("vipred", 1 + j))
        if not self.ch400 and not self.ch444:
            v = self._ue("vcpred", cap=7)
            if v > 3:
                raise ParseDesync("chroma pred mode")

    def _mvd(self, comp):
        # mvd bits keyed on the previous |mvd|'s magnitude bucket (shared
        # across components/MBs within the slice — motion coherence;
        # A/B +0.11% of output; the per-component split measured -0.03%)
        v = self._se("vmvd", comp + 2 * self._mvd_b)
        a = v if v >= 0 else -v
        self._mvd_b = 0 if a == 0 else (1 if a < 4 else (2 if a < 32 else 3))

    def _pcm(self):
        c = self.c
        # pcm_alignment_zero_bit: deterministic given the bit position —
        # compress asserts zeros, decompress regenerates them; not modeled
        if c.is_compress:
            while c.r.bitpos & 7:
                if c.r.u(1) != 0:
                    raise ParseDesync("nonzero pcm alignment bit")
        else:
            while c.w.bitpos & 7:
                c.w.u(0, 1)
        bd_y = self.sps.bit_depth_luma
        bd_c = self.sps.bit_depth_chroma
        n_chroma = (0 if self.ch400 else 512 if self.ch444
                    else 256 if self.ch422 else 128)
        n_bytes = (256 * bd_y + n_chroma * bd_c) >> 3
        for _ in range(n_bytes):
            for i in range(8):
                c.bit(("pcm", i))
        m = self.mby, self.mbx
        self.pic.nnz_luma[m[0], m[1], :] = 16
        self.pic.nnz_chroma_ac[m[0], m[1], :] = 16
        self.pic.nnz_c44[:, m[0], m[1], :] = 16
        self.pic.t8x8[m[0], m[1]] = 0
        self.pic.mbclass[m[0], m[1]] = 7  # I_PCM: intra for neighbor ctx

    def parse_macroblock_layer(self):
        pic = self.pic
        x, y = self.mbx, self.mby
        pic.slice_id[y, x] = self.sid
        pic.skip[y, x] = 0
        pic.nnz_luma[y, x, :] = 0
        pic.nnz_chroma_ac[y, x, :] = 0
        pic.nnz_c44[:, y, x, :] = 0
        pic.t8x8[y, x] = 0
        stype = self.stype
        mbt_a = 0 if stype == SLICE_I else (1 if stype == SLICE_P else 2)
        inc = 0  # neighbor intra-ness: mb_type clusters spatially
        if self._avail(x - 1, y):
            inc += 1 if pic.mbclass[y, x - 1] >= 5 else 0
        if self._avail(x, y - 1):
            inc += 1 if pic.mbclass[y - 1, x] >= 5 else 0
        raw = self._ue("vmbt", mbt_a + 3 * inc)
        intra_base = None
        if stype == SLICE_I:
            intra_base = raw
        elif stype == SLICE_P:
            if raw >= 5:
                intra_base = raw - 5
        else:
            if raw >= 23:
                intra_base = raw - 23

        i16 = False
        cbp_luma = 0
        cbp_chroma = 0
        t8 = 0
        is_intra = intra_base is not None
        if is_intra:
            if intra_base > 25:
                raise ParseDesync("mb_type out of range")
            if intra_base == 25:  # I_PCM
                self._pcm()
                return
            if intra_base == 0:  # I_NxN
                if self.pps.transform_8x8_mode_flag:
                    t8 = self.c.bit(("vt8", self._t8_inc()))
                self._intra_pred_modes(4 if t8 else 16)
            else:  # I_16x16
                i16 = True
                b = intra_base - 1
                cbp_luma = 15 if b >= 12 else 0
                cbp_chroma = (b >> 2) % 3
                if not self.ch400 and not self.ch444:
                    v = self._ue("vcpred", cap=7)
                    if v > 3:
                        raise ParseDesync("chroma pred mode")
        elif stype == SLICE_P:
            self._p_inter(raw)
        else:
            self._b_inter(raw)

        if not i16:
            cn = self._ue("vcbp", 1 if is_intra else 0)
            if self.ch400 or self.ch444:  # ChromaArrayType 0/3: Table 9-4
                tabm = CBP_INTRA_MONO if is_intra else CBP_INTER_MONO
                if cn >= 16:
                    raise ParseDesync("cbp codeNum out of range")
                cbp = tabm[cn]
            else:
                tabc = CBP_INTRA if is_intra else CBP_INTER
                if cn >= 48:
                    raise ParseDesync("cbp codeNum out of range")
                cbp = tabc[cn]
            cbp_luma = cbp & 15
            cbp_chroma = cbp >> 4
            if (cbp_luma and self.pps.transform_8x8_mode_flag and not is_intra
                    and self._t8_allowed(raw)):
                t8 = self.c.bit(("vt8", self._t8_inc()))
        pic.mbclass[y, x] = 5 if is_intra else 4
        pic.t8x8[y, x] = t8

        if cbp_luma or cbp_chroma or i16:
            self._se("vdqp")
            self._residuals(i16, cbp_luma, cbp_chroma)

    def _t8_allowed(self, raw):
        # NoSubMbPartSizeLessThan8x8Flag (7.4.5) for the inter cases
        if self.stype == SLICE_P:
            if raw in (3, 4):
                return all(s == 0 for s in self._sub_types)
            return True
        info = _B_TYPE_INFO.get(raw)
        if raw == 0:  # B_Direct_16x16
            return bool(self.sps.direct_8x8_inference_flag)
        if raw == 22:
            for s in self._sub_types:
                n, shape, pred = _B_SUB_INFO[s]
                if pred == PRED_DIRECT:
                    if not self.sps.direct_8x8_inference_flag:
                        return False
                elif shape != 0:
                    return False
            return True
        return info is not None

    def _p_inter(self, raw):
        self._sub_types = ()
        if raw > 4:
            raise ParseDesync("P mb_type out of range")
        nref = self.nref0
        if raw == 0:
            if nref > 1:
                self._te("vref", 0, nref - 1)
            self._mvd(0)
            self._mvd(1)
        elif raw in (1, 2):
            for _ in range(2):
                if nref > 1:
                    self._te("vref", 0, nref - 1)
            for _ in range(2):
                self._mvd(0)
                self._mvd(1)
        else:  # P_8x8 / P_8x8ref0
            subs = []
            for _ in range(4):
                s = self._ue("vsub", 0, cap=15)
                if s > 3:
                    raise ParseDesync("P sub_mb_type out of range")
                subs.append(s)
            self._sub_types = tuple(subs)
            if raw == 3 and nref > 1:  # P_8x8 (ref0 variant skips refs)
                for _ in range(4):
                    self._te("vref", 0, nref - 1)
            nparts = {0: 1, 1: 2, 2: 2, 3: 4}
            for s in subs:
                for _ in range(nparts[s]):
                    self._mvd(0)
                    self._mvd(1)

    def _b_inter(self, raw):
        self._sub_types = ()
        info = _B_TYPE_INFO.get(raw)
        if info is None:
            raise ParseDesync("B mb_type out of range")
        npart, shape, modes = info
        if raw == 0:  # B_Direct_16x16: no pred elements
            return
        if raw == 22:  # B_8x8
            subs = []
            for _ in range(4):
                s = self._ue("vsub", 1, cap=15)
                if s > 12:
                    raise ParseDesync("B sub_mb_type out of range")
                subs.append(s)
            self._sub_types = tuple(subs)
            for lst, nref in ((0, self.nref0), (1, self.nref1)):
                if nref <= 1:
                    continue
                use = PRED_L0 if lst == 0 else PRED_L1
                for s in subs:
                    _, _, pred = _B_SUB_INFO[s]
                    if pred in (use, PRED_BI):
                        self._te("vref", lst, nref - 1)
            for lst in (0, 1):
                use = PRED_L0 if lst == 0 else PRED_L1
                for s in subs:
                    n, shape2, pred = _B_SUB_INFO[s]
                    if pred in (use, PRED_BI):
                        for _ in range(n):
                            self._mvd(0)
                            self._mvd(1)
            return
        # partitioned B types (1..21)
        for lst, nref in ((0, self.nref0), (1, self.nref1)):
            if nref <= 1:
                continue
            use = PRED_L0 if lst == 0 else PRED_L1
            for p in range(npart):
                if modes[p] in (use, PRED_BI):
                    self._te("vref", lst, nref - 1)
        for lst in (0, 1):
            use = PRED_L0 if lst == 0 else PRED_L1
            for p in range(npart):
                if modes[p] in (use, PRED_BI):
                    self._mvd(0)
                    self._mvd(1)

    def _residuals(self, i16, cbp_luma, cbp_chroma):
        pic = self.pic
        x, y = self.mbx, self.mby
        if self.ch444:
            # ChromaArrayType 3: three luma-style planes share cbp_luma
            for plane in range(3):
                nmap = pic.nnz_luma if plane == 0 else pic.nnz_c44[plane - 1]
                if i16:
                    self.residual_block(self._nc_luma(0, plane), 16, cat=2)
                for i8 in range(4):
                    if not (cbp_luma & (1 << i8)):
                        continue
                    for i4 in range(4):
                        blk = i8 * 4 + i4
                        total = self.residual_block(
                            self._nc_luma(blk, plane), 15 if i16 else 16,
                            cat=0)
                        nmap[y, x, blk] = total
            return
        if i16:
            self.residual_block(self._nc_luma(0), 16, cat=2)
        for i8 in range(4):
            if not (cbp_luma & (1 << i8)):
                continue
            for i4 in range(4):
                blk = i8 * 4 + i4
                total = self.residual_block(self._nc_luma(blk),
                                            15 if i16 else 16, cat=0)
                pic.nnz_luma[y, x, blk] = total
        if self.ch400:
            return
        if cbp_chroma & 3:
            nc_dc = -2 if self.ch422 else -1
            n_dc = 8 if self.ch422 else 4
            for _comp in range(2):
                self.residual_block(nc_dc, n_dc, cat=2)
        if cbp_chroma & 2:
            for comp in range(2):
                for sub in range(self.n_chroma_ac):
                    total = self.residual_block(self._nc_chroma(comp, sub),
                                                15, cat=1)
                    pic.nnz_chroma_ac[y, x, comp * 8 + sub] = total

    # -- slice data loop (7.3.4) -----------------------------------------
    def _mark_skip(self, addr):
        x, yy = addr % self.W, addr // self.W
        self.pic.slice_id[yy, x] = self.sid
        self.pic.skip[yy, x] = 1
        self.pic.mbclass[yy, x] = 1
        self.pic.nnz_luma[yy, x, :] = 0
        self.pic.nnz_chroma_ac[yy, x, :] = 0
        self.pic.nnz_c44[:, yy, x, :] = 0
        self.pic.t8x8[yy, x] = 0

    def parse_slice_data(self, mb_count=None):
        c = self.c
        total_mbs = self.W * self.H
        addr = self.hdr.first_mb_in_slice
        done = 0
        while True:
            if self.stype != SLICE_I:
                run = self._ue("vskip")
                if addr + run > total_mbs:
                    raise ParseDesync("skip run past picture")
                for _ in range(run):
                    self._mark_skip(addr)
                    addr += 1
                    done += 1
                if run > 0 and not c.more_data(done, mb_count):
                    break
            if addr >= total_mbs:
                raise ParseDesync("mb address past picture")
            self.mbx = addr % self.W
            self.mby = addr // self.W
            self.parse_macroblock_layer()
            addr += 1
            done += 1
            if not c.more_data(done, mb_count):
                break
        return done
