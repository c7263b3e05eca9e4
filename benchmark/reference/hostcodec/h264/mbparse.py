"""H.264 CABAC slice-data parser (clauses 7.3.4/7.3.5, 9.3.3.1).

This is the framework's replacement for the reference's inverted-control hook
surface (av_decoder + patched ffmpeg, recode.cpp:79-237 / SURVEY.md C5/C18):
a *forward* parser that walks macroblock syntax and drives an abstract coder,
so the same code runs:

  compress   — bins come from the real CABAC payload (CompressCoder decodes
               them, re-encodes for self-verification, and feeds the model)
  decompress — bins come from the recoded model stream and are fed to the
               CABAC re-encoder to regenerate the original payload
  trace      — compress-direction without a model (bring-up/validation)

Determinism-elision protocol (the reference's C9/C12 num_nonzeros + EOB
trick, recode.cpp:852-936, 1444-1446, generalized):
  * per-block num_nonzeros is coded out-of-band with spatial priors;
    significance/last flags that become deterministic given nnz are never
    entropy-coded (last flags vanish entirely; trailing sig runs too),
  * end_of_slice_flag is never entropy-coded: the slice's mb_count is stored
    in the container, making every terminate bin deterministic,
  * at compress time every "deterministic" bin is asserted against the real
    decoded bin — a mismatch raises ParseDesync -> literal fallback.

Scope: progressive + MBAFF frames, 4:2:0/4:2:2/4:4:4, any bit depth,
I/P/B slices, High profile transform-8x8, I_PCM (round 3).  MBAFF neighbor derivation mirrors the
hooked decoder's semantics (fill_decode_neighbors left-pair split + y remap,
skip/field-flag register conventions) — the same behavior the reference
inherits from its ffmpeg patch (SURVEY.md C18, recode.cpp:149-235).  I_PCM
macroblocks recode (escape flush + raw samples + engine re-init); PAFF
field pictures recode as half-height all-field-coded pictures (plain
raster addressing, field context rows — tests/test_paff.py).
"""

import numpy as np

from ..ops._tables_data import (
    COEFF_ABS_LEVEL1_CTX,
    COEFF_ABS_LEVEL_M1_OFFSET,
    COEFF_ABS_LEVEL_TRANSITION,
    COEFF_ABS_LEVELGT1_CTX,
    LAST_COEFF_FLAG_OFFSET,
    LAST_COEFF_FLAG_OFFSET_8X8,
    SIG_COEFF_FLAG_OFFSET,
    SIG_COEFF_FLAG_OFFSET_8X8,
)
from .geometry import BLK4_X, BLK4_Y, RASTER_TO_BLK4, blk4_neighbor, chroma_blk_neighbor
from .params import UnsupportedStream
from .slicehdr import SLICE_I, SLICE_P, SLICE_SI, SLICE_SP


class ParseDesync(Exception):
    """A bin predicted as deterministic disagreed with the decoded bin."""


# ---------------------------------------------------------------------------
# MB classes (stored per MB for neighbor context derivation)
MB_UNSEEN = 0
MB_P_SKIP = 1
MB_B_SKIP = 2
MB_B_DIRECT = 3  # B_Direct_16x16
MB_INTER = 4
MB_I_NXN = 5  # I_4x4 / I_8x8
MB_I16 = 6
MB_I_PCM = 7
MB_SI = 8  # SI macroblock (Intra_4x4 content, qs-domain reconstruction)

# inter partition prediction modes
PRED_L0, PRED_L1, PRED_BI, PRED_DIRECT, PRED_NONE = 1, 2, 3, 4, 0

# B mb_type table: mb_type index -> (npart, part_shape, [pred modes])
# part_shape: 0=16x16, 1=16x8, 2=8x16, 3=8x8(sub)
_B_TYPE_INFO = {
    0: (1, 0, [PRED_DIRECT]),
    1: (1, 0, [PRED_L0]),
    2: (1, 0, [PRED_L1]),
    3: (1, 0, [PRED_BI]),
    4: (2, 1, [PRED_L0, PRED_L0]),
    5: (2, 2, [PRED_L0, PRED_L0]),
    6: (2, 1, [PRED_L1, PRED_L1]),
    7: (2, 2, [PRED_L1, PRED_L1]),
    8: (2, 1, [PRED_L0, PRED_L1]),
    9: (2, 2, [PRED_L0, PRED_L1]),
    10: (2, 1, [PRED_L1, PRED_L0]),
    11: (2, 2, [PRED_L1, PRED_L0]),
    12: (2, 1, [PRED_L0, PRED_BI]),
    13: (2, 2, [PRED_L0, PRED_BI]),
    14: (2, 1, [PRED_L1, PRED_BI]),
    15: (2, 2, [PRED_L1, PRED_BI]),
    16: (2, 1, [PRED_BI, PRED_L0]),
    17: (2, 2, [PRED_BI, PRED_L0]),
    18: (2, 1, [PRED_BI, PRED_L1]),
    19: (2, 2, [PRED_BI, PRED_L1]),
    20: (2, 1, [PRED_BI, PRED_BI]),
    21: (2, 2, [PRED_BI, PRED_BI]),
    22: (4, 3, None),  # B_8x8
}

# B sub_mb_type -> (n subparts, subpart shape 0=8x8,1=8x4,2=4x8,3=4x4, pred)
_B_SUB_INFO = {
    0: (1, 0, PRED_DIRECT),
    1: (1, 0, PRED_L0),
    2: (1, 0, PRED_L1),
    3: (1, 0, PRED_BI),
    4: (2, 1, PRED_L0),
    5: (2, 2, PRED_L0),
    6: (2, 1, PRED_L1),
    7: (2, 2, PRED_L1),
    8: (2, 1, PRED_BI),
    9: (2, 2, PRED_BI),
    10: (4, 3, PRED_L0),
    11: (4, 3, PRED_L1),
    12: (4, 3, PRED_BI),
}

# residual block categories (ctxBlockCat)
CAT_LUMA_DC = 0
CAT_LUMA_AC = 1
CAT_LUMA_4x4 = 2
CAT_CHROMA_DC = 3
CAT_CHROMA_AC = 4
CAT_LUMA_8x8 = 5

_MAX_COEFF = {0: 16, 1: 15, 2: 16, 3: 4, 4: 15, 5: 64,
              6: 16, 7: 15, 8: 16, 9: 64, 10: 16, 11: 15, 12: 16, 13: 64}

# coded_block_flag ctx base per ctxBlockCat (9.3.3.1.1.9 ctxIdxOffset
# assignment): cats 0-4 at 85+4*cat; the 4:4:4 extensions live in the
# 460-483 (Cb/Cr non-8x8) and 1012-1023 (8x8 luma/Cb/Cr) ranges
CBF_CTX_BASE = (85, 89, 93, 97, 101, 1012, 460, 464, 468, 1016, 472, 476,
                480, 1020)
# cat -> colour plane (444 luma-style residual per plane); None = 420/422
_CAT_PLANE = {0: 0, 1: 0, 2: 0, 5: 0, 6: 1, 7: 1, 8: 1, 9: 1,
              10: 2, 11: 2, 12: 2, 13: 2}
_CAT_DC = (CAT_LUMA_DC, 6, 10)
_CAT_AC = (CAT_LUMA_AC, 7, 11)
_CAT_44 = (CAT_LUMA_4x4, 8, 12)
_CAT_88 = (CAT_LUMA_8x8, 9, 13)


class PicState:
    """Per-picture macroblock state arrays — the FrameBuffer analog
    (framebuffer.h:5-88 / block.h:4-23) as dense numpy tensors, which is
    exactly the layout mirrored into HBM for the device model."""

    def __init__(self, width_mbs, height_mbs):
        w, h = width_mbs, height_mbs
        self.w, self.h = w, h
        self.slice_id = np.full((h, w), -1, np.int32)
        self.mbclass = np.zeros((h, w), np.uint8)
        self.skip = np.zeros((h, w), np.uint8)
        self.cbp_luma = np.zeros((h, w), np.uint8)  # 4 bits
        self.cbp_chroma = np.zeros((h, w), np.uint8)  # 0..2
        self.t8x8 = np.zeros((h, w), np.uint8)
        self.chroma_mode = np.zeros((h, w), np.uint8)
        # effective coded_block_flag maps (incl. PCM=1 / derived-from-cbp rules)
        self.cbf_luma_dc = np.zeros((h, w), np.uint8)
        self.cbf_luma = np.zeros((h, w, 16), np.uint8)
        self.cbf_chroma_dc = np.zeros((h, w, 2), np.uint8)
        self.cbf_chroma_ac = np.zeros((h, w, 16), np.uint8)  # comp*8+sub
        # num_nonzeros per block (model priors / OOB coding priors)
        self.nnz_luma = np.zeros((h, w, 16), np.uint8)
        self.nnz_luma_dc = np.zeros((h, w), np.uint8)
        self.nnz_chroma_dc = np.zeros((h, w, 2), np.uint8)
        self.nnz_chroma_ac = np.zeros((h, w, 16), np.uint8)  # comp*8+sub
        # motion: |mvd| stored per 4x4 per list per comp; ref per 8x8 per list
        self.mvd = np.zeros((2, h, w, 16, 2), np.int32)
        self.refidx = np.full((2, h, w, 4), -1, np.int8)
        self.intra_nxn = np.zeros((h, w), np.uint8)  # is I_NxN (for mb_type ctx)
        # MBAFF: per-MB field-coding flag (both MBs of a pair share a value);
        # rows interleave pairs: y = 2*pair_row + bottom
        self.field = np.zeros((h, w), np.uint8)
        # 4:4:4: Cb/Cr planes carry luma-style per-4x4 cbf/nnz maps
        # (cbf_chroma_dc / nnz_chroma_dc double as the per-plane DC maps)
        self.cbf_c44 = np.zeros((2, h, w, 16), np.uint8)
        self.nnz_c44 = np.zeros((2, h, w, 16), np.uint8)
        # model v8: sign of each block's first (DC) coefficient, +1/-1
        # (0 = absent) — neighbor context for DC sign coding
        self.sgn_luma = np.zeros((h, w, 16), np.int8)
        self.sgn_luma_dc = np.zeros((h, w), np.int8)
        self.sgn_chroma_dc = np.zeros((h, w, 2), np.int8)
        self.sgn_c44 = np.zeros((2, h, w, 16), np.int8)


class SliceParser:
    def __init__(self, sps, pps, header, pic, prev_pic, coder, slice_id, isolate=False):
        self.sps = sps
        self.pps = pps
        self.hdr = header
        self.pic = pic
        self.prev = prev_pic
        self.c = coder
        self.sid = slice_id
        # isolate=True restricts model priors to this slice + the previous
        # picture, making slices of a picture decodable in parallel
        # (container model_scope=SLICE); CABAC contexts are same-slice-only
        # regardless (clause 6.4.8 availability).
        self.isolate = isolate
        self.W = sps.pic_width_in_mbs
        # PAFF field picture: a half-height picture whose MBs are all
        # field-coded (no pair addressing, no mixing — field context rows
        # only); the PicState is sized by the caller to match
        self.field_pic = bool(getattr(header, "field_pic", False))
        self.H = (sps.pic_height_in_map_units *
                  (1 if sps.frame_mbs_only_flag else 2)) >> self.field_pic
        self.mbaff = bool(getattr(header, "mbaff", False))
        # MBAFF state: cur_field = current pair's field flag (decoded,
        # predicted, or provisional); eff_field mirrors ffmpeg's
        # sl->mb_field_decoding_flag "most recent value" convention used for
        # ctx derivation before the current pair's flag is decoded
        self.cur_field = 1 if self.field_pic else 0
        self.eff_field = 0
        self.field_known = False
        # SP slices parse exactly like P (7.3.5: same mb layer; the qs
        # domain only changes reconstruction); SI keeps its own type for
        # the mb_type prefix bin and the absent skip flag
        self.stype = (SLICE_P if header.slice_type == SLICE_SP
                      else header.slice_type)
        # 4:2:2: 2x4 chroma 4x4-block grid, 8-coeff chroma DC
        self.ch422 = sps.chroma_format_idc == 2
        # 4:4:4 (non-separate): Cb/Cr recode as luma-style planes (cats 6-13)
        # ChromaArrayType semantics (7.4.2.1.1): separate colour planes
        # code each plane as a monochrome picture (ChromaArrayType 0)
        self.ch444 = (sps.chroma_format_idc == 3
                      and not sps.separate_colour_plane_flag)
        # monochrome (ChromaArrayType 0): no chroma planes at all — no
        # chroma pred mode, no chroma cbp bins, luma-only residuals
        self.ch400 = (sps.chroma_format_idc == 0
                      or bool(sps.separate_colour_plane_flag))
        self.ch_grid_h = 4 if self.ch422 else 2
        self.n_chroma_ac = 8 if self.ch422 else 4
        self.nref0 = header.num_ref_idx_l0_active
        self.nref1 = header.num_ref_idx_l1_active
        self.prev_qp_delta_nz = 0
        # model v9: previous nonzero |qp_delta| mapped-unary magnitude
        # (model context, not spec state: sticky across the spec's
        # skip/PCM qp-context resets)
        self.prev_qp_mag = 0
        self.mb_count = 0
        self.mbx = 0
        self.mby = 0

    # -- availability ----------------------------------------------------
    def _avail(self, pos):
        if pos is None:
            return False
        x, y = pos
        if x < 0 or y < 0 or x >= self.W or y >= self.H:
            return False
        return self.pic.slice_id[y, x] == self.sid

    def _left(self):
        if self.mbaff:
            return self._left_xy[0]
        return (self.mbx - 1, self.mby)

    def _up(self):
        if self.mbaff:
            return self._top_xy
        return (self.mbx, self.mby - 1)

    # -- MBAFF neighbor derivation ----------------------------------------
    # Mirrors ffmpeg's fill_decode_neighbors (h264_mvpred.h): the left MB
    # pair splits into (LTOP, LBOT) used for current 4x4 rows 0-1 / 2-3, with
    # a per-row y remap (left_block_options); the top MB depends on the
    # current/above parities.  This is the behavior of the hooked decoder the
    # reference rides (SURVEY.md C18, recode.cpp:149-235).
    def _field_at(self, x, y):
        if x < 0 or y < 0 or x >= self.W or y >= self.H:
            return 0
        return int(self.pic.field[y, x])

    def _mbaff_neighbors(self):
        x, y = self.mbx, self.mby
        f = self.cur_field
        bottom = y & 1
        if not f:
            top = (x, y - 1)
        else:
            top = (x, y - 2)
            if not bottom and not self._field_at(x, y - 2):
                top = (x, y - 1)
        lx = x - 1
        ltop, lbot = (lx, y), (lx, y)
        lmap = (0, 1, 2, 3)
        if lx >= 0 and self._field_at(lx, y) != f:
            if bottom:
                if f:  # field MB, frame left pair
                    ltop, lbot, lmap = (lx, y - 1), (lx, y), (0, 2, 0, 2)
                else:  # frame MB, field left pair
                    ltop = lbot = (lx, y - 1)
                    lmap = (2, 2, 3, 3)
            else:
                if f:
                    ltop, lbot, lmap = (lx, y), (lx, y + 1), (0, 2, 0, 2)
                else:
                    ltop = lbot = (lx, y)
                    lmap = (0, 0, 1, 1)
        self._top_xy = top
        self._left_xy = (ltop, lbot)
        self._left_ymap = lmap

    def _blk_nb(self, blk, dx, dy):
        """4x4 luma neighbor (left/up single step), MBAFF-aware."""
        if not self.mbaff:
            return blk4_neighbor(self.mbx, self.mby, blk, dx, dy)
        x4 = int(BLK4_X[blk]) + dx
        y4 = int(BLK4_Y[blk]) + dy
        if 0 <= x4 <= 3 and 0 <= y4 <= 3:
            return (self.mbx, self.mby), int(RASTER_TO_BLK4[y4 * 4 + x4])
        if x4 < 0:
            nmb = self._left_xy[y4 >> 1]
            return nmb, int(RASTER_TO_BLK4[self._left_ymap[y4] * 4 + 3])
        # y4 < 0 (parser never steps right/down across MBs)
        return self._top_xy, int(RASTER_TO_BLK4[3 * 4 + x4])

    def _chroma_nb(self, blk, dx, dy):
        """Chroma 4x4 neighbor on the 2 x grid_h block grid, MBAFF-aware."""
        if not self.mbaff:
            return chroma_blk_neighbor(self.mbx, self.mby, blk, dx, dy, self.ch_grid_h)
        gh = self.ch_grid_h
        xc, yc = (blk & 1) + dx, (blk >> 1) + dy
        if 0 <= xc <= 1 and 0 <= yc < gh:
            return (self.mbx, self.mby), yc * 2 + xc
        if xc < 0:
            r = yc * 4 // gh  # luma-equivalent row
            nmb = self._left_xy[r >> 1]
            return nmb, (self._left_ymap[r] * gh // 4) * 2 + 1
        # yc < 0
        return self._top_xy, (gh - 1) * 2 + xc

    # -- coder shims -----------------------------------------------------
    def _bin(self, ctx, mkey=None):
        return self.c.coded_bin(ctx, mkey if mkey is not None else ("ctx", ctx))

    def _bin_det(self, ctx, value):
        return self.c.coded_bin_det(ctx, value)

    def _bypass(self, mkey):
        return self.c.bypass_bin(mkey)

    # -- element parsers -------------------------------------------------
    def parse_mb_skip(self):
        base = 11 if self.stype == SLICE_P else 24
        if self.mbaff:
            # ffmpeg decode_cabac_mb_skip: neighbors derived from the pair-top
            # address using the not-yet-overwritten field flag (eff_field)
            x, y = self.mbx, self.mby
            py = y & ~1
            a = (x - 1, py)
            if (y & 1) and self._avail(a) and self.eff_field == self._field_at(*a):
                a = (x - 1, py + 1)
            if self.eff_field:
                b = (x, py - 1)
                if not (y & 1) and self._avail(b) and self._field_at(*b):
                    b = (x, py - 2)
            else:
                b = (x, y - 1)
        else:
            a, b = self._left(), self._up()
        inc = 0
        if self._avail(a) and not self.pic.skip[a[1], a[0]]:
            inc += 1
        if self._avail(b) and not self.pic.skip[b[1], b[0]]:
            inc += 1
        return self._bin(base + inc, ("skip", self.stype, inc))

    # -- MBAFF mb_field_decoding_flag --------------------------------------
    def parse_field_flag(self):
        """Decode/encode mb_field_decoding_flag (ctx 70-72, 9.3.3.1.1.2):
        left term = previous pair's flag (ffmpeg's stale-register trick, only
        when mb_x > 0), above term = above pair's flag gated on slice
        membership."""
        x, y = self.mbx, self.mby
        inc = self.eff_field if x > 0 else 0
        ay = (y & ~1) - 2
        if (
            ay >= 0
            and self.pic.slice_id[ay, x] == self.sid
            and self.pic.field[ay, x]
        ):
            inc += 1
        return self._bin(70 + inc, ("fieldf", inc))

    def _predict_field(self):
        """Inference for a both-skipped pair (7.4.4 / ffmpeg
        predict_field_decoding_flag): left pair in same slice, else above
        pair, else 0.  Called at the bottom MB of the pair."""
        x, y = self.mbx, self.mby
        ty = y & ~1
        for nx, ny in ((x - 1, ty), (x, ty - 1)):
            if (
                0 <= nx < self.W
                and 0 <= ny < self.H
                and self.pic.slice_id[ny, nx] == self.sid
            ):
                return int(self.pic.field[ny, nx])
        return 0

    def parse_mb_type_i_suffix(self, base, intra_slice):
        """Shared I16x16/PCM suffix after the I_NxN bin (Table 9-36).

        Context layout verified against libavcodec's compiled decoder:
        I slice (base=3, +2 skew): cbf_luma ctx 6, chroma 7/8, pred 9/10;
        inter suffix (base=17/32): cbf_luma +1, chroma +2/+2, pred +3/+3.
        """
        skew = 2 if intra_slice else 0
        if self.c.cabac_terminate_pcm():
            return None  # I_PCM escape (Table 9-36 bin string "11")
        cbf_luma = self._bin(base + skew + 1, ("i16cbf",))
        cbp_chroma = 0
        a, b = self._left(), self._up()
        p = self.pic
        ca = int(p.cbp_chroma[a[1], a[0]]) if self._avail(a) else 3
        cb = int(p.cbp_chroma[b[1], b[0]]) if self._avail(b) else 3
        if self._bin(base + skew + 2, ("i16cbc0", ca, cb)):
            cbp_chroma = 1 + self._bin(
                base + skew + (3 if intra_slice else 2),
                ("i16cbc1", int(ca == 2), int(cb == 2))
            )
        pm1 = self._bin(base + skew + (4 if intra_slice else 3), ("i16pm1",))
        pm0 = self._bin(base + skew + (5 if intra_slice else 3), ("i16pm0",))
        pred_mode = 2 * pm1 + pm0
        return cbf_luma, cbp_chroma, pred_mode

    def parse_mb_type(self):
        """Returns (mbclass, info) where info depends on class."""
        p = self.pic
        if self.stype == SLICE_SI:
            # SI mb_type (9.3.2.5, Table 9-11 ctxIdxOffset 0): prefix bin
            # 0 -> SI macroblock; 1 -> the full I-slice binarization.
            # Prefix ctxInc per 9.3.3.1.1.3: neighbors counted unless SI.
            a, b = self._left(), self._up()
            inc = 0
            for pos in (a, b):
                if self._avail(pos) and p.mbclass[pos[1], pos[0]] != MB_SI:
                    inc += 1
            if not self._bin(0 + inc, ("simbtype", inc)):
                return MB_SI, None
            inc2 = 0
            if self._avail(a) and p.mbclass[a[1], a[0]] != MB_I_NXN:
                inc2 += 1
            if self._avail(b) and p.mbclass[b[1], b[0]] != MB_I_NXN:
                inc2 += 1
            if not self._bin(3 + inc2, ("imbtype", inc2)):
                return MB_I_NXN, None
            info = self.parse_mb_type_i_suffix(3, True)
            return (MB_I_PCM, None) if info is None else (MB_I16, info)
        if self.stype == SLICE_I:
            a, b = self._left(), self._up()
            inc = 0
            if self._avail(a) and p.mbclass[a[1], a[0]] != MB_I_NXN:
                inc += 1
            if self._avail(b) and p.mbclass[b[1], b[0]] != MB_I_NXN:
                inc += 1
            if not self._bin(3 + inc, ("imbtype", inc)):
                return MB_I_NXN, None
            info = self.parse_mb_type_i_suffix(3, True)
            return (MB_I_PCM, None) if info is None else (MB_I16, info)

        if self.stype == SLICE_P:
            inc2 = 0
            for w, pos in ((1, self._left()), (2, self._up())):
                if self._avail(pos) and p.mbclass[pos[1], pos[0]] in (
                    MB_I_NXN, MB_I16, MB_I_PCM, MB_SI,
                ):
                    inc2 += w
            if self._bin(14, ("pmbtype0", inc2)):
                if not self._bin(17, ("pmbtype_intra",)):
                    return MB_I_NXN, None
                info = self.parse_mb_type_i_suffix(17, False)
                return (MB_I_PCM, None) if info is None else (MB_I16, info)
            if not self._bin(15, ("pmbtype1",)):
                # '00x': 16x16 or 8x8
                if self._bin(16, ("pmbtype2a",)):
                    return MB_INTER, ("P8x8",)
                return MB_INTER, ("P16x16",)
            # '01x': 16x8 / 8x16
            if self._bin(17, ("pmbtype2b",)):
                return MB_INTER, ("P16x8",)
            return MB_INTER, ("P8x16",)

        # B slice (prefix base 27, Table 9-37)
        a, bpos = self._left(), self._up()
        inc = 0
        for pos in (a, bpos):
            if self._avail(pos):
                cls = p.mbclass[pos[1], pos[0]]
                if cls not in (MB_B_SKIP, MB_B_DIRECT):
                    inc += 1
        if not self._bin(27 + inc, ("bmbtype0", inc)):
            return MB_B_DIRECT, None
        if not self._bin(30, ("bmbtype1",)):
            t = 1 + self._bin(32, ("bmbtype2",))
            return MB_INTER, ("B", t)
        v = self._bin(31, ("bmbtype3",)) << 3
        v |= self._bin(32, ("bmbtype4",)) << 2
        v |= self._bin(32, ("bmbtype5",)) << 1
        v |= self._bin(32, ("bmbtype6",))
        if v < 8:
            return MB_INTER, ("B", v + 3)
        if v == 13:
            if not self._bin(32, ("bmbtype_intra",)):
                return MB_I_NXN, None
            info = self.parse_mb_type_i_suffix(32, False)
            return (MB_I_PCM, None) if info is None else (MB_I16, info)
        if v == 14:
            return MB_INTER, ("B", 11)
        if v == 15:
            return MB_INTER, ("B", 22)
        v = ((v - 8) << 1) | self._bin(32, ("bmbtype7",))
        return MB_INTER, ("B", v + 12)

    def parse_sub_mb_type_p(self):
        if self._bin(21, ("psub0",)):
            return 0  # 8x8
        if not self._bin(22, ("psub1",)):
            return 1  # 8x4
        if self._bin(23, ("psub2",)):
            return 2  # 4x8
        return 3  # 4x4

    def parse_sub_mb_type_b(self):
        if not self._bin(36, ("bsub0",)):
            return 0  # direct
        if not self._bin(37, ("bsub1",)):
            return 1 + self._bin(39, ("bsub2",))
        t = 3
        if self._bin(38, ("bsub3",)):
            if self._bin(39, ("bsub4",)):
                return 11 + self._bin(39, ("bsub5",))
            t += 4
        t += 2 * self._bin(39, ("bsub6",))
        t += self._bin(39, ("bsub7",))
        return t

    def parse_transform_8x8(self):
        a, b = self._left(), self._up()
        inc = 0
        if self._avail(a) and self.pic.t8x8[a[1], a[0]]:
            inc += 1
        if self._avail(b) and self.pic.t8x8[b[1], b[0]]:
            inc += 1
        return self._bin(399 + inc, ("t8x8", inc))

    def parse_intra_pred_modes(self, n_blocks):
        for _ in range(n_blocks):
            if not self._bin(68, ("ipredf",)):
                for j in range(3):
                    self._bin(69, ("ipredr", j))

    def parse_chroma_pred_mode(self):
        a, b = self._left(), self._up()
        p = self.pic
        inc = 0
        for pos in (a, b):
            if self._avail(pos):
                cls = p.mbclass[pos[1], pos[0]]
                if cls in (MB_I_NXN, MB_I16, MB_SI) and p.chroma_mode[pos[1], pos[0]] != 0:
                    inc += 1
        if not self._bin(64 + inc, ("cpred0", inc)):
            return 0
        if not self._bin(67, ("cpred1",)):
            return 1
        return 2 + self._bin(67, ("cpred2",))

    def parse_cbp(self, mbclass):
        p = self.pic
        intra = int(mbclass in (MB_I_NXN, MB_I16, MB_SI))
        a, b = self._left(), self._up()
        avail_a, avail_b = self._avail(a), self._avail(b)
        cbp = 0
        # luma bits, 8x8 raster order; cond = 1 when neighbor 8x8 NOT coded
        for i8 in range(4):
            x8, y8 = i8 & 1, i8 >> 1
            if x8 == 0:
                if avail_a:
                    if self.mbaff:
                        # row y8's left 8x8 lives in left_xy[y8] at the
                        # remapped row (ffmpeg's composite left_cbp)
                        la = self._left_xy[y8]
                        lb = (self._left_ymap[2 * y8] >> 1) * 2 + 1
                        cond_a = 0 if (p.cbp_luma[la[1], la[0]] >> lb) & 1 else 1
                    else:
                        cond_a = 0 if (p.cbp_luma[a[1], a[0]] >> (y8 * 2 + 1)) & 1 else 1
                else:
                    cond_a = 0
            else:
                cond_a = 0 if (cbp >> (y8 * 2)) & 1 else 1
            if y8 == 0:
                if avail_b:
                    cond_b = 0 if (p.cbp_luma[b[1], b[0]] >> (2 + x8)) & 1 else 1
                else:
                    cond_b = 0
            else:
                cond_b = 0 if (cbp >> x8) & 1 else 1
            if self._bin(73 + cond_a + 2 * cond_b, ("cbpl", i8, cond_a + 2 * cond_b, intra)):
                cbp |= 1 << i8
        if self.ch444 or self.ch400:  # no chroma cbp bins (4:4:4 applies
            return cbp, 0             # luma bits per plane; 4:0:0 has none)
        # chroma: TU cMax=2
        cond_a = 1 if (avail_a and p.cbp_chroma[a[1], a[0]] != 0) else 0
        cond_b = 1 if (avail_b and p.cbp_chroma[b[1], b[0]] != 0) else 0
        cbp_c = 0
        if self._bin(77 + cond_a + 2 * cond_b, ("cbpc0", cond_a + 2 * cond_b)):
            cond_a = 1 if (avail_a and p.cbp_chroma[a[1], a[0]] == 2) else 0
            cond_b = 1 if (avail_b and p.cbp_chroma[b[1], b[0]] == 2) else 0
            cbp_c = 1 + self._bin(
                81 + cond_a + 2 * cond_b, ("cbpc1", cond_a + 2 * cond_b)
            )
        return cbp, cbp_c

    def parse_mb_qp_delta(self):
        if not self._bin(60 + self.prev_qp_delta_nz, ("qpd0", self.prev_qp_delta_nz)):
            self.prev_qp_delta_nz = 0
            self.prev_qp_mag = 0
            return 0
        v = 1
        pm = self.prev_qp_mag
        if self._bin(62, ("qpd1", pm)):
            v = 2
            while self._bin(63, ("qpd2", min(v - 2, 4), pm)):
                v += 1
                if v > 128:
                    raise UnsupportedStream("qp_delta overflow")
        self.prev_qp_delta_nz = 1
        self.prev_qp_mag = min(v, 7)
        # mapped unary -> signed (9.3.2.7)
        return (v + 1) >> 1 if v & 1 else -(v >> 1)

    # -- motion ----------------------------------------------------------
    def _nref_eff(self, lst):
        """Active ref count for ref_idx presence: field MBs address per-field
        lists with twice the entries (7.4.3 / ffmpeg ref_count << MB_MBAFF),
        so ref_idx is coded even when the slice header count is 1."""
        n = self.nref0 if lst == 0 else self.nref1
        return n << 1 if (self.mbaff and self.cur_field) else n

    def parse_ref_idx(self, lst, blk):
        """blk = top-left 4x4 blk idx of the partition."""
        p = self.pic
        inc = 0
        for dx, dy, weight in ((-1, 0, 1), (0, -1, 2)):
            (nmb, nblk) = self._blk_nb(blk, dx, dy)
            if self._avail(nmb):
                quad = (int(BLK4_Y[nblk]) >> 1) * 2 + (int(BLK4_X[nblk]) >> 1)
                r = int(p.refidx[lst, nmb[1], nmb[0], quad])
                if self.mbaff and r > 0:
                    # parity rescale (field refs are per-field): a field
                    # neighbor's ref halves for a frame MB, a frame
                    # neighbor's doubles for a field MB (9.3.3.1.1.6)
                    nf = self._field_at(nmb[0], nmb[1])
                    if self.cur_field and not nf:
                        r <<= 1
                    elif not self.cur_field and nf:
                        r >>= 1
                if r > 0:
                    inc += weight
        v = 0
        ctxs = (54 + inc, 58, 59)
        while self._bin(ctxs[min(v, 2)], ("ref", min(v, 2), inc if v == 0 else 0)):
            v += 1
            if v > 32:
                raise UnsupportedStream("ref_idx overflow")
        return v

    def parse_mvd(self, lst, blk, comp):
        p = self.pic
        base = 40 if comp == 0 else 47
        s = 0
        for dx, dy in ((-1, 0), (0, -1)):
            (nmb, nblk) = self._blk_nb(blk, dx, dy)
            if self._avail(nmb):
                v = int(p.mvd[lst, nmb[1], nmb[0], nblk, comp])
                if comp == 1 and self.mbaff:
                    # vertical |mvd| parity rescale (9.3.3.1.1.7): frame
                    # neighbor of a field MB halves, field neighbor of a
                    # frame MB doubles (both sides clamp-equivalently)
                    nf = self._field_at(nmb[0], nmb[1])
                    if self.cur_field and not nf:
                        v >>= 1
                    elif not self.cur_field and nf:
                        v <<= 1
                s += v
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        mkey = ("mvd", comp, inc)
        if not self._bin(base + inc, mkey):
            return 0
        v = 1
        ctx_off = (3, 4, 5, 6, 6, 6, 6, 6)
        while v < 9 and self._bin(base + ctx_off[v - 1], ("mvdp", comp, min(v, 5))):
            v += 1
        if v == 9:
            k = 3
            while self._bypass(("mvde", comp, min(k - 3, 5))):
                v += 1 << k
                k += 1
                if k > 30:
                    raise UnsupportedStream("mvd overflow")
            while k:
                k -= 1
                v += self._bypass(("mvdb", comp, min(k, 7))) << k
        sign = self._bypass(("mvds", comp))
        return -v if sign else v

    def _store_mvd(self, lst, blk, w4, h4, vx, vy):
        p = self.pic
        x0, y0 = int(BLK4_X[blk]), int(BLK4_Y[blk])
        for yy in range(y0, y0 + h4):
            for xx in range(x0, x0 + w4):
                b = int(RASTER_TO_BLK4[yy * 4 + xx])
                p.mvd[lst, self.mby, self.mbx, b, 0] = abs(vx)
                p.mvd[lst, self.mby, self.mbx, b, 1] = abs(vy)

    def _parse_mvd_part(self, lst, blk, w4, h4):
        vx = self.parse_mvd(lst, blk, 0)
        vy = self.parse_mvd(lst, blk, 1)
        self._store_mvd(lst, blk, w4, h4, vx, vy)

    # -- residuals -------------------------------------------------------
    def _cbf_neighbor(self, cat, blk, is_intra):
        """ctxIdxInc for coded_block_flag (9.3.3.1.1.9) via effective maps."""
        p = self.pic
        inc = 0
        plane = _CAT_PLANE.get(cat) if cat not in (CAT_CHROMA_DC, CAT_CHROMA_AC) else None
        for di, (dx, dy) in enumerate(((-1, 0), (0, -1))):
            if cat in _CAT_DC:
                nmb = self._left() if dx else self._up()
                if not self._avail(nmb):
                    cond = 1 if is_intra else 0
                elif cat == CAT_LUMA_DC:
                    cond = int(p.cbf_luma_dc[nmb[1], nmb[0]])
                else:  # 4:4:4 Cb/Cr DC: per-plane map
                    cond = int(p.cbf_chroma_dc[nmb[1], nmb[0], plane - 1])
            elif plane is not None:  # luma-style AC/4x4/8x8 (8x8 only in 444)
                nmb, nblk = self._blk_nb(blk, dx, dy)
                if not self._avail(nmb):
                    cond = 1 if is_intra else 0
                elif cat in _CAT_88 and not p.t8x8[nmb[1], nmb[0]]:
                    # 4:4:4 8x8 cbf ctx: a neighbor not coded with the 8x8
                    # transform contributes 0 (its 8x8 transform block is
                    # unavailable) — oracle-validated against x264 output
                    cond = 0
                elif plane == 0:
                    cond = int(p.cbf_luma[nmb[1], nmb[0], nblk])
                else:
                    cond = int(p.cbf_c44[plane - 1, nmb[1], nmb[0], nblk])
            elif cat == CAT_CHROMA_DC:
                nmb = self._left() if dx else self._up()
                if not self._avail(nmb):
                    cond = 1 if is_intra else 0
                else:
                    cond = int(p.cbf_chroma_dc[nmb[1], nmb[0], blk])
            else:  # CAT_CHROMA_AC: blk = comp*8 + sub (2x2 or 2x4 grid)
                comp, sub = blk >> 3, blk & 7
                nmb, nsub = self._chroma_nb(sub, dx, dy)
                if not self._avail(nmb):
                    cond = 1 if is_intra else 0
                else:
                    cond = int(p.cbf_chroma_ac[nmb[1], nmb[0], comp * 8 + nsub])
            inc += cond << di
        return inc

    def _sgn_neighbor(self, cat, blk):
        """Model v8: left/above DC-sign context for a block's first (DC)
        coefficient — 3*(L+1)+(A+1) with each neighbor sign in {-1,0,+1}
        (0 = unavailable, uncoded, or zero DC).  Neighbor resolution mirrors
        _cbf_neighbor so both directions stay symmetric."""
        p = self.pic
        plane = _CAT_PLANE.get(cat) if cat != CAT_CHROMA_DC else None
        v = [0, 0]
        for di, (dx, dy) in enumerate(((-1, 0), (0, -1))):
            if cat in _CAT_DC:
                nmb = self._left() if dx else self._up()
                if not self._avail(nmb):
                    continue
                if cat == CAT_LUMA_DC:
                    v[di] = int(p.sgn_luma_dc[nmb[1], nmb[0]])
                else:  # 4:4:4 Cb/Cr DC
                    v[di] = int(p.sgn_chroma_dc[nmb[1], nmb[0], plane - 1])
            elif cat == CAT_CHROMA_DC:
                nmb = self._left() if dx else self._up()
                if self._avail(nmb):
                    v[di] = int(p.sgn_chroma_dc[nmb[1], nmb[0], blk])
            else:  # luma-style 4x4/8x8 cells
                nmb, nblk = self._blk_nb(blk, dx, dy)
                if not self._avail(nmb):
                    continue
                if plane == 0:
                    v[di] = int(p.sgn_luma[nmb[1], nmb[0], nblk])
                else:
                    v[di] = int(p.sgn_c44[plane - 1, nmb[1], nmb[0], nblk])
        return 3 * (v[0] + 1) + (v[1] + 1)

    def _sgn_store(self, cat, blk, s0):
        """Record a block's DC-coefficient sign for successors' contexts
        (8x8 blocks replicate into their four 4x4 cells, like nnz)."""
        p = self.pic
        x, y = self.mbx, self.mby
        if cat == CAT_LUMA_DC:
            p.sgn_luma_dc[y, x] = s0
        elif cat in _CAT_DC:
            p.sgn_chroma_dc[y, x, _CAT_PLANE[cat] - 1] = s0
        elif cat == CAT_CHROMA_DC:
            p.sgn_chroma_dc[y, x, blk] = s0
        else:
            plane = _CAT_PLANE[cat]
            m = p.sgn_luma if plane == 0 else p.sgn_c44[plane - 1]
            if cat in _CAT_88:
                x0, y0 = int(BLK4_X[blk]), int(BLK4_Y[blk])
                for yy in (y0, y0 + 1):
                    for xx in (x0, x0 + 1):
                        m[y, x, int(RASTER_TO_BLK4[yy * 4 + xx])] = s0
            else:
                m[y, x, blk] = s0

    def parse_residual_block(self, cat, blk, is_intra, has_cbf, nnz_prior):
        """Parse one residual block; returns (nnz, coeff levels summary).

        Implements the OOB-nnz + determinism-elision protocol described in
        the module docstring.  `blk` identifies the block for neighbor maps.
        """
        c = self.c
        max_coeff = _MAX_COEFF[cat]
        if cat == CAT_CHROMA_DC and self.ch422:
            max_coeff = 8
        fld0 = self.cur_field if (self.mbaff or self.field_pic) else 0
        if has_cbf:
            inc = self._cbf_neighbor(cat, blk, is_intra)
            # model v6: block-position quadrant joins the cbf key
            if cat in _CAT_DC or cat == CAT_CHROMA_DC:
                pq = 0
            elif cat == CAT_CHROMA_AC:
                pq = (blk & 7) & 3
            else:
                pq = (int(BLK4_Y[blk]) >> 1) * 2 + (int(BLK4_X[blk]) >> 1)
            cbf = self._bin(
                CBF_CTX_BASE[cat] + inc,
                ("cbf", cat + 16 * fld0, inc + 4 * pq, min(nnz_prior, 7), int(is_intra)),
            )
            self._last_cbf = cbf
            if not cbf:
                return 0
        else:
            self._last_cbf = 1
        # --- significance map (field MBs use the field ctx rows, 9.3.3.1.3)
        fld = self.cur_field if (self.mbaff or self.field_pic) else 0
        if cat in _CAT_88:
            sig8_base = SIG_COEFF_FLAG_OFFSET[fld][cat]
            last8_base = LAST_COEFF_FLAG_OFFSET[fld][cat]
            sig_ctx = [sig8_base + SIG_COEFF_FLAG_OFFSET_8X8[fld][i] for i in range(63)]
            last_ctx = [last8_base + LAST_COEFF_FLAG_OFFSET_8X8[i] for i in range(63)]
        else:
            sig_base = SIG_COEFF_FLAG_OFFSET[fld][cat]
            last_base = LAST_COEFF_FLAG_OFFSET[fld][cat]
            if cat == CAT_CHROMA_DC:
                numc = 2 if self.ch422 else 1  # spec: Min(i / NumC8x8, 2)
                sig_ctx = [sig_base + min(i // numc, 2) for i in range(max_coeff - 1)]
                last_ctx = [last_base + min(i // numc, 2) for i in range(max_coeff - 1)]
            else:
                sig_ctx = [sig_base + i for i in range(max_coeff - 1)]
                last_ctx = [last_base + i for i in range(max_coeff - 1)]

        if c.is_compress:
            # decode the real sig map (capturing the CABAC-state mixing prior
            # per position BEFORE each decode), then emit nnz + bins
            sig = []
            pcabs = []
            n_sig = 0
            for i in range(max_coeff - 1):
                pcabs.append(c.cabac_p1(sig_ctx[i]))
                s = c.cabac_raw_bin(sig_ctx[i])
                sig.append(s)
                if s:
                    n_sig += 1
                    if c.cabac_raw_bin(last_ctx[i]):
                        break
            else:
                sig.append(1)  # implicit last position significant
                n_sig += 1
            nnz = n_sig
            c.put_nnz(nnz, cat + 16 * fld, max_coeff, nnz_prior, blk)
            self._replay_sig(cat, sig, nnz, sig_ctx, last_ctx, emit=True,
                             pcabs=pcabs, intra=int(is_intra) + 2 * fld)
        else:
            nnz = c.get_nnz(cat + 16 * fld, max_coeff, nnz_prior, blk)
            sig = self._replay_sig(cat, None, nnz, sig_ctx, last_ctx, emit=False,
                                   intra=int(is_intra) + 2 * fld)

        # --- levels (backward from last significant) ---
        positions = [i for i, s in enumerate(sig) if s]
        assert len(positions) == nnz
        nzb = min(nnz, 7)  # block-density bucket for level keys
        node = 0
        abs_base = COEFF_ABS_LEVEL_M1_OFFSET[cat]
        gt1_off = 8 if cat == CAT_CHROMA_DC else 0
        # model v6 key enrichment (round 3, A/B-measured): levels are
        # conditioned on a scan-position bucket; the sign on its (position,
        # magnitude) — DC/low-frequency signs carry real signal
        posdiv = 8 if cat in _CAT_88 else 2
        for pos in reversed(positions):
            pb2 = min(pos // posdiv, 7)
            ctx1 = abs_base + COEFF_ABS_LEVEL1_CTX[node]
            if self._bin(ctx1, ("lvl1", cat, COEFF_ABS_LEVEL1_CTX[node], int(is_intra), nzb, pb2)):
                coeff = 2
                ctxg = abs_base + COEFF_ABS_LEVELGT1_CTX[gt1_off + node]
                while coeff < 15 and self._bin(
                    ctxg, ("lvlg", cat, COEFF_ABS_LEVELGT1_CTX[gt1_off + node], min(coeff, 7), int(is_intra), nzb, pb2)
                ):
                    coeff += 1
                if coeff == 15:
                    j = 0
                    while self._bypass(("lvle", cat, min(j, 7))):
                        j += 1
                        if j > 30:
                            raise UnsupportedStream("level overflow")
                    add = 1
                    while j:
                        j -= 1
                        add += add + self._bypass(("lvlb", cat, min(j, 7)))
                    coeff += add - 1
                node = COEFF_ABS_LEVEL_TRANSITION[1][node]
            else:
                coeff = 1
                node = COEFF_ABS_LEVEL_TRANSITION[0][node]
            # model v8: true-DC signs (scan position 0 of a DC-bearing
            # category) get a left/above neighbor-sign context
            if pos == 0 and cat not in _CAT_AC and cat != CAT_CHROMA_AC:
                nb = self._sgn_neighbor(cat, blk)
                sb = self._bypass(("sgn", cat, 0, min(coeff, 3), nb))
                self._sgn_store(cat, blk, -1 if sb else 1)
            else:
                self._bypass(("sgn", cat, min(pos, 3), min(coeff, 3)))
        return nnz

    def _replay_sig(self, cat, sig, nnz, sig_ctx, last_ctx, emit, pcabs=None, intra=0):
        """Walk the sig/last map applying determinism elision.

        emit=True (compress): `sig` is the decoded map; non-deterministic sig
        bins are sent to the model; deterministic ones are asserted.
        emit=False (decompress): reconstruct `sig` from nnz + model bins and
        replay every implied CABAC bin into the re-encoder.
        Returns the sig list.
        """
        c = self.c
        max_coeff = len(sig_ctx) + 1
        out = [] if sig is None else None
        found = 0
        i = 0
        while i < max_coeff:
            remaining_pos = max_coeff - i
            need = nnz - found
            if i == max_coeff - 1:
                s = 1 if need > 0 else 0  # implicit final position
                det = True
            elif need == 0:
                s, det = 0, True
            elif need == remaining_pos:
                s, det = 1, True
            else:
                s, det = None, False
            if emit:
                actual = sig[i] if i < len(sig) else 0
                if det:
                    if actual != s:
                        raise ParseDesync(f"sig map det mismatch cat={cat} i={i}")
                else:
                    c.put_modeled(
                        ("sig", cat, i, min(found, 7), min(need, 7), intra),
                        actual,
                        pcabs[i],
                    )
                s = actual
            else:
                if not det:
                    s = c.get_modeled(
                        ("sig", cat, i, min(found, 7), min(need, 7), intra),
                        c.cabac_p1(sig_ctx[i]),
                    )
                out.append(s)
                # replay implied CABAC bins for the re-encoder
                if i < max_coeff - 1:
                    c.cabac_raw_bin_put(sig_ctx[i], s)
            if s:
                found += 1
                if i < max_coeff - 1 and not emit:
                    c.cabac_raw_bin_put(last_ctx[i], 1 if found == nnz else 0)
                if found == nnz and i < max_coeff - 1:
                    # last flag terminates the map
                    if emit:
                        pass  # compress already consumed real last flags
                    break
            i += 1
        if emit:
            return None
        # pad remaining positions as non-significant
        while len(out) < max_coeff:
            out.append(0)
        return out

    # -- macroblock layer ------------------------------------------------
    def parse_macroblock(self):
        """One MB: skip flag (+ MBAFF field flag interleaving handled by the
        caller for skipped pairs), then the macroblock layer."""
        skip = 0
        if self.stype not in (SLICE_I, SLICE_SI):  # SI: no skip flag
            skip = self.parse_mb_skip()
        if skip:
            self._store_skip_mb()
            return True
        if self.mbaff and not self.field_known:
            self.cur_field = self.eff_field = self.parse_field_flag()
            self.field_known = True
            if self.mby & 1:  # top MB was skipped: retro-set its stored flag
                self.pic.field[self.mby - 1, self.mbx] = self.cur_field
        self.parse_macroblock_layer()
        return False

    def _store_skip_mb(self):
        p = self.pic
        x, y = self.mbx, self.mby
        stype = self.stype
        p.slice_id[y, x] = self.sid
        p.mbclass[y, x] = MB_P_SKIP if stype == SLICE_P else MB_B_SKIP
        p.skip[y, x] = 1
        p.field[y, x] = self.cur_field
        p.refidx[:, y, x, :] = 0 if stype == SLICE_P else -1
        self.prev_qp_delta_nz = 0

    def parse_macroblock_layer(self):
        p = self.pic
        x, y = self.mbx, self.mby
        self._sub_types = None
        p.field[y, x] = self.cur_field
        if self.mbaff:
            self._mbaff_neighbors()

        mbclass, info = self.parse_mb_type()
        p.slice_id[y, x] = self.sid
        p.mbclass[y, x] = mbclass
        p.skip[y, x] = 0

        if mbclass == MB_I_PCM:
            self._parse_pcm()
            return

        t8x8 = 0
        is_intra = mbclass in (MB_I_NXN, MB_I16, MB_SI)
        cbp_luma = cbp_chroma = 0
        i16_cbf_luma = 0

        if mbclass == MB_SI:
            # Intra_4x4 content; no transform_size_8x8_flag (7.3.5 gates
            # it on mb_type == I_NxN)
            self.parse_intra_pred_modes(16)
            if not self.ch444 and not self.ch400:
                p.chroma_mode[y, x] = self.parse_chroma_pred_mode()
        elif mbclass == MB_I_NXN:
            if self.pps.transform_8x8_mode_flag:
                t8x8 = self.parse_transform_8x8()
            self.parse_intra_pred_modes(4 if t8x8 else 16)
            if not self.ch444 and not self.ch400:
                # 4:4:4 reuses the luma modes (7.3.5.1); 4:0:0 has no chroma
                p.chroma_mode[y, x] = self.parse_chroma_pred_mode()
        elif mbclass == MB_I16:
            i16_cbf_luma, cbp_chroma, _pred = info
            cbp_luma = 15 if i16_cbf_luma else 0
            if not self.ch444 and not self.ch400:
                p.chroma_mode[y, x] = self.parse_chroma_pred_mode()
        elif mbclass == MB_B_DIRECT:
            pass  # no mb_pred syntax
        else:
            self._parse_inter_pred(info)

        # coded_block_pattern (not for I16)
        sub_types = getattr(self, "_sub_types", None)
        if mbclass not in (MB_I16,):
            cbp_luma, cbp_chroma = self.parse_cbp(mbclass)
            # transform_size_8x8_flag for inter MBs (7.3.5 condition)
            if (
                cbp_luma
                and self.pps.transform_8x8_mode_flag
                and mbclass not in (MB_I_NXN, MB_SI)
                and self._t8x8_allowed(mbclass, info, sub_types)
            ):
                t8x8 = self.parse_transform_8x8()
        p.cbp_luma[y, x] = cbp_luma
        p.cbp_chroma[y, x] = cbp_chroma
        p.t8x8[y, x] = t8x8

        if cbp_luma or cbp_chroma or mbclass == MB_I16:
            self.parse_mb_qp_delta()
            self._parse_residuals(mbclass, cbp_luma, cbp_chroma, t8x8, is_intra)
        else:
            self.prev_qp_delta_nz = 0

    def _parse_pcm(self):
        """I_PCM macroblock (7.3.5, 9.3.1.2): raw samples after the flushed
        terminate, both CABAC engines re-initialize; neighbor semantics per
        the spec's PCM rules (coded_block_flags 1, cbp 15/2, nnz saturated,
        chroma pred mode 0, qp-delta chain reset)."""
        p = self.pic
        x, y = self.mbx, self.mby
        chs = 0 if self.ch400 else 256 if self.ch444 else 128 if self.ch422 else 64
        n = (256 * self.sps.bit_depth_luma + 2 * chs * self.sps.bit_depth_chroma) >> 3
        self.c.pcm_samples(n)
        p.cbf_c44[:, y, x, :] = 1
        p.nnz_c44[:, y, x, :] = 16
        p.cbp_luma[y, x] = 15
        p.cbp_chroma[y, x] = 2
        p.t8x8[y, x] = 0
        p.chroma_mode[y, x] = 0
        p.cbf_luma_dc[y, x] = 1
        p.cbf_luma[y, x, :] = 1
        p.cbf_chroma_dc[y, x, :] = 1
        p.cbf_chroma_ac[y, x, :] = 1
        p.nnz_luma[y, x, :] = 16
        p.nnz_luma_dc[y, x] = 16
        p.nnz_chroma_dc[y, x, :] = 8 if self.ch422 else 4
        p.nnz_chroma_ac[y, x, :] = 15
        self.prev_qp_delta_nz = 0

    def _t8x8_allowed(self, mbclass, info, sub_types):
        if mbclass == MB_B_DIRECT:
            return bool(self.sps.direct_8x8_inference_flag)
        if info and info[0] == "P8x8":
            return all(t == 0 for t in sub_types)
        if info and info[0] == "B" and info[1] == 22:
            # all sub parts must be 8x8 (and direct subs need 8x8 inference)
            for t in sub_types:
                if t == 0:
                    if not self.sps.direct_8x8_inference_flag:
                        return False
                elif t > 3:
                    return False
            return True
        return True

    def _parse_inter_pred(self, info):
        p = self.pic
        x, y = self.mbx, self.mby
        self._sub_types = None
        blk_bottom = int(RASTER_TO_BLK4[2 * 4 + 0])  # (x4=0, y4=2)
        blk_right = int(RASTER_TO_BLK4[0 * 4 + 2])  # (x4=2, y4=0)
        if info[0] == "P16x16":
            parts = [(0, 4, 4, PRED_L0)]
        elif info[0] == "P16x8":
            parts = [(0, 4, 2, PRED_L0), (blk_bottom, 4, 2, PRED_L0)]
        elif info[0] == "P8x16":
            parts = [(0, 2, 4, PRED_L0), (blk_right, 2, 4, PRED_L0)]
        elif info[0] == "P8x8":
            sub = [self.parse_sub_mb_type_p() for _ in range(4)]
            self._sub_types = sub
            self._parse_p8x8(sub)
            return
        else:  # B
            btype = info[1]
            npart, shape, modes = _B_TYPE_INFO[btype]
            if btype == 22:
                sub = [self.parse_sub_mb_type_b() for _ in range(4)]
                self._sub_types = sub
                self._parse_b8x8(sub)
                return
            if shape == 0:
                parts = [(0, 4, 4, modes[0])]
            elif shape == 1:
                parts = [(0, 4, 2, modes[0]), (blk_bottom, 4, 2, modes[1])]
            else:
                parts = [(0, 2, 4, modes[0]), (blk_right, 2, 4, modes[1])]

        refs = {0: {}, 1: {}}
        for lst, nref in ((0, self._nref_eff(0)), (1, self._nref_eff(1))):
            for blk, w4, h4, mode in parts:
                if mode == PRED_BI or mode - 1 == lst:
                    r = self.parse_ref_idx(lst, blk) if nref > 1 else 0
                    refs[lst][blk] = r
                    # store on all covered 8x8 quadrants
                    self._store_ref(lst, blk, w4, h4, r)
        for lst in (0, 1):
            for blk, w4, h4, mode in parts:
                if mode == PRED_BI or mode - 1 == lst:
                    self._parse_mvd_part(lst, blk, w4, h4)

    def _store_ref(self, lst, blk, w4, h4, r):
        p = self.pic
        x0, y0 = int(BLK4_X[blk]), int(BLK4_Y[blk])
        for yy in range(y0, y0 + h4, 2):
            for xx in range(x0, x0 + w4, 2):
                p.refidx[lst, self.mby, self.mbx, (yy >> 1) * 2 + (xx >> 1)] = r

    def _parse_p8x8(self, sub):
        # sub_mb_pred (7.3.5.2): all ref_idx_l0, then all mvd_l0
        for i8 in range(4):
            blk = int(RASTER_TO_BLK4[(i8 >> 1) * 2 * 4 + (i8 & 1) * 2])
            if self._nref_eff(0) > 1:
                r = self.parse_ref_idx(0, blk)
            else:
                r = 0
            self._store_ref(0, blk, 2, 2, r)
        for i8 in range(4):
            self._parse_sub_mvds(0, i8, sub[i8], is_b=False)

    def _parse_b8x8(self, sub):
        for lst, nref in ((0, self._nref_eff(0)), (1, self._nref_eff(1))):
            for i8 in range(4):
                t = sub[i8]
                if t == 0:
                    continue  # direct
                _, _, mode = _B_SUB_INFO[t]
                if mode == PRED_BI or mode - 1 == lst:
                    blk = int(RASTER_TO_BLK4[(i8 >> 1) * 2 * 4 + (i8 & 1) * 2])
                    r = self.parse_ref_idx(lst, blk) if nref > 1 else 0
                    self._store_ref(lst, blk, 2, 2, r)
        for lst in (0, 1):
            for i8 in range(4):
                t = sub[i8]
                if t == 0:
                    continue
                _, _, mode = _B_SUB_INFO[t]
                if mode == PRED_BI or mode - 1 == lst:
                    self._parse_sub_mvds(lst, i8, t, is_b=True)

    def _parse_sub_mvds(self, lst, i8, subtype, is_b):
        x0, y0 = (i8 & 1) * 2, (i8 >> 1) * 2
        if is_b:
            nsp, shape, _mode = _B_SUB_INFO[subtype]
        else:
            shape = subtype  # P: 0=8x8,1=8x4,2=4x8,3=4x4
            nsp = (1, 2, 2, 4)[shape]
        for sp in range(nsp):
            if shape == 0:
                bx, by, w4, h4 = x0, y0, 2, 2
            elif shape == 1:  # 8x4
                bx, by, w4, h4 = x0, y0 + sp, 2, 1
            elif shape == 2:  # 4x8
                bx, by, w4, h4 = x0 + sp, y0, 1, 2
            else:  # 4x4
                bx, by, w4, h4 = x0 + (sp & 1), y0 + (sp >> 1), 1, 1
            blk = int(RASTER_TO_BLK4[by * 4 + bx])
            self._parse_mvd_part(lst, blk, w4, h4)

    def _parse_residuals(self, mbclass, cbp_luma, cbp_chroma, t8x8, is_intra):
        if self.ch444:
            # 4:4:4 (ChromaArrayType 3, 7.3.5.3): each colour plane recodes
            # with the luma block structure under its own category row
            # (Cb 6-9, Cr 10-13) and its own cbf/nnz maps
            for plane in range(3):
                self._parse_plane_residuals(plane, mbclass, cbp_luma, t8x8,
                                            is_intra)
            return
        p = self.pic
        x, y = self.mbx, self.mby
        prev = self.prev

        def prior_luma(blk):
            # neighbor + previous-frame nnz prior (reference's FrameBuffer
            # prior, recode.cpp:865-895) — bucketed average
            tot, n = 0, 0
            for dx, dy in ((-1, 0), (0, -1)):
                nmb, nblk = self._blk_nb(blk, dx, dy)
                if 0 <= nmb[0] < self.W and 0 <= nmb[1] < self.H:
                    nsid = p.slice_id[nmb[1], nmb[0]]
                    if (nsid == self.sid) if self.isolate else (nsid >= 0):
                        tot += int(p.nnz_luma[nmb[1], nmb[0], nblk])
                        n += 1
            if prev is not None:
                tot += int(prev.nnz_luma[y, x, blk])
                n += 1
            return tot // n if n else 0

        if mbclass == MB_I16:
            nnz = self.parse_residual_block(
                CAT_LUMA_DC, 0, True, True, int(prev.nnz_luma_dc[y, x]) if prev is not None else 0
            )
            p.cbf_luma_dc[y, x] = self._last_cbf
            p.nnz_luma_dc[y, x] = nnz
            if cbp_luma:
                for i8 in range(4):
                    for j in range(4):
                        blk = i8 * 4 + j
                        nnz = self.parse_residual_block(
                            CAT_LUMA_AC, blk, True, True, prior_luma(blk)
                        )
                        p.cbf_luma[y, x, blk] = self._last_cbf
                        p.nnz_luma[y, x, blk] = nnz
        else:
            for i8 in range(4):
                if not (cbp_luma >> i8) & 1:
                    continue
                if t8x8:
                    blk0 = int(RASTER_TO_BLK4[(i8 >> 1) * 8 + (i8 & 1) * 2])
                    nnz = self.parse_residual_block(
                        CAT_LUMA_8x8, blk0, is_intra, False, prior_luma(blk0)
                    )
                    for j in range(4):
                        blk = i8 * 4 + j
                        p.cbf_luma[y, x, blk] = 1
                        p.nnz_luma[y, x, blk] = min(nnz, 255) >> 2
                else:
                    for j in range(4):
                        blk = i8 * 4 + j
                        nnz = self.parse_residual_block(
                            CAT_LUMA_4x4, blk, is_intra, True, prior_luma(blk)
                        )
                        p.cbf_luma[y, x, blk] = self._last_cbf
                        p.nnz_luma[y, x, blk] = nnz

        def prior_chroma_dc(comp):
            tot, n = 0, 0
            for dx, dy in ((-1, 0), (0, -1)):
                nx, ny = self._left() if dx else self._up()
                if 0 <= nx < self.W and 0 <= ny < self.H:
                    nsid = p.slice_id[ny, nx]
                    if (nsid == self.sid) if self.isolate else (nsid >= 0):
                        tot += int(p.nnz_chroma_dc[ny, nx, comp])
                        n += 1
            if prev is not None:
                tot += int(prev.nnz_chroma_dc[y, x, comp])
                n += 1
            return tot // n if n else 0

        def prior_chroma_ac(idx):
            comp, sub = idx >> 3, idx & 7
            tot, n = 0, 0
            for dx, dy in ((-1, 0), (0, -1)):
                nmb, nsub = self._chroma_nb(sub, dx, dy)
                if 0 <= nmb[0] < self.W and 0 <= nmb[1] < self.H:
                    nsid = p.slice_id[nmb[1], nmb[0]]
                    if (nsid == self.sid) if self.isolate else (nsid >= 0):
                        tot += int(p.nnz_chroma_ac[nmb[1], nmb[0], comp * 8 + nsub])
                        n += 1
            if prev is not None:
                tot += int(prev.nnz_chroma_ac[y, x, idx])
                n += 1
            return tot // n if n else 0

        if cbp_chroma:
            for comp in range(2):
                pr = prior_chroma_dc(comp)
                nnz = self.parse_residual_block(CAT_CHROMA_DC, comp, is_intra, True, pr)
                p.cbf_chroma_dc[y, x, comp] = self._last_cbf
                p.nnz_chroma_dc[y, x, comp] = nnz
        if cbp_chroma == 2:
            for comp in range(2):
                for sub in range(self.n_chroma_ac):
                    idx = comp * 8 + sub
                    pr = prior_chroma_ac(idx)
                    nnz = self.parse_residual_block(
                        CAT_CHROMA_AC, idx, is_intra, True, pr
                    )
                    p.cbf_chroma_ac[y, x, idx] = self._last_cbf
                    p.nnz_chroma_ac[y, x, idx] = nnz

    def _plane_maps(self, plane):
        """(cbf_dc set/get, cbf_blk, nnz_dc, nnz_blk) arrays for a plane."""
        p = self.pic
        if plane == 0:
            return None, p.cbf_luma, None, p.nnz_luma
        return None, p.cbf_c44[plane - 1], None, p.nnz_c44[plane - 1]

    def _parse_plane_residuals(self, plane, mbclass, cbp_luma, t8x8, is_intra):
        p = self.pic
        x, y = self.mbx, self.mby
        prev = self.prev
        cdc, cac, c44, c88 = _CAT_DC[plane], _CAT_AC[plane], _CAT_44[plane], _CAT_88[plane]
        _, cbf_blk, _, nnz_blk = self._plane_maps(plane)
        prev_blk = None if prev is None else (
            prev.nnz_luma if plane == 0 else prev.nnz_c44[plane - 1])

        def prior(blk):
            tot, n = 0, 0
            for dx, dy in ((-1, 0), (0, -1)):
                nmb, nblk = self._blk_nb(blk, dx, dy)
                if 0 <= nmb[0] < self.W and 0 <= nmb[1] < self.H:
                    nsid = p.slice_id[nmb[1], nmb[0]]
                    if (nsid == self.sid) if self.isolate else (nsid >= 0):
                        tot += int(nnz_blk[nmb[1], nmb[0], nblk])
                        n += 1
            if prev_blk is not None:
                tot += int(prev_blk[y, x, blk])
                n += 1
            return tot // n if n else 0

        if mbclass == MB_I16:
            if plane == 0:
                pr = int(prev.nnz_luma_dc[y, x]) if prev is not None else 0
            else:
                pr = int(prev.nnz_chroma_dc[y, x, plane - 1]) if prev is not None else 0
            nnz = self.parse_residual_block(cdc, 0 if plane == 0 else plane - 1,
                                            True, True, pr)
            if plane == 0:
                p.cbf_luma_dc[y, x] = self._last_cbf
                p.nnz_luma_dc[y, x] = nnz
            else:
                p.cbf_chroma_dc[y, x, plane - 1] = self._last_cbf
                p.nnz_chroma_dc[y, x, plane - 1] = nnz
            if cbp_luma:
                for blk in range(16):
                    nnz = self.parse_residual_block(cac, blk, True, True, prior(blk))
                    cbf_blk[y, x, blk] = self._last_cbf
                    nnz_blk[y, x, blk] = nnz
            return
        for i8 in range(4):
            if not (cbp_luma >> i8) & 1:
                continue
            if t8x8:
                blk0 = int(RASTER_TO_BLK4[(i8 >> 1) * 8 + (i8 & 1) * 2])
                # 4:4:4 8x8 blocks DO code coded_block_flag (7.3.5.3.3:
                # maxNumCoeff != 64 || ChromaArrayType == 3)
                nnz = self.parse_residual_block(c88, blk0, is_intra, True,
                                                prior(blk0))
                for j in range(4):
                    blk = i8 * 4 + j
                    cbf_blk[y, x, blk] = self._last_cbf
                    nnz_blk[y, x, blk] = min(nnz, 255) >> 2
            else:
                for j in range(4):
                    blk = i8 * 4 + j
                    nnz = self.parse_residual_block(c44, blk, is_intra, True,
                                                    prior(blk))
                    cbf_blk[y, x, blk] = self._last_cbf
                    nnz_blk[y, x, blk] = nnz

    # The cbf bit of the most recent parse_residual_block call (set there).
    _last_cbf = 0

    # -- slice loop ------------------------------------------------------
    def parse_slice_data(self, mb_count=None):
        """Parse the whole slice.  compress: mb_count=None (discovered);
        decompress: mb_count from the container (makes end_of_slice
        deterministic).  Returns number of MBs parsed."""
        if self.mbaff:
            return self._parse_slice_data_mbaff(mb_count)
        addr = self.hdr.first_mb_in_slice
        n = 0
        total = self.W * self.H
        while True:
            if addr >= total:
                raise ParseDesync("mb address beyond picture")
            self.mbx, self.mby = addr % self.W, addr // self.W
            self.parse_macroblock()
            n += 1
            if mb_count is None:
                eos = self.c.cabac_terminate_eos()
            else:
                eos = 1 if n == mb_count else 0
                self.c.cabac_terminate_eos_put(eos)
            if eos:
                break
            addr += 1
        self.mb_count = n
        return n

    def _parse_slice_data_mbaff(self, mb_count=None):
        """MBAFF slice loop (7.3.4): addresses walk MB pairs; the field flag
        sits between the skip flag(s) and the first non-skipped MB layer;
        end_of_slice_flag appears only after bottom MBs."""
        pair = self.hdr.first_mb_in_slice
        n = 0
        total_pairs = self.W * (self.H >> 1)
        while True:
            if pair >= total_pairs:
                raise ParseDesync("mb pair address beyond picture")
            px, py = pair % self.W, pair // self.W
            self.field_known = False
            if px == 0 and pair != self.hdr.first_mb_in_slice:
                # pair-row wrap: the provisional flag register is re-seeded
                # with the 7.4.4 inference (left pair unavailable -> above
                # pair), mirroring ffmpeg's predict_field_decoding_flag call
                # in the row-advance path
                self.mbx, self.mby = px, 2 * py + 1
                self.eff_field = self._predict_field()
            self.cur_field = self.eff_field  # provisional (stale register)
            top_skipped = False
            for bottom in (0, 1):
                self.mbx, self.mby = px, 2 * py + bottom
                skipped = self.parse_macroblock()
                if bottom == 0:
                    top_skipped = skipped
                elif skipped and top_skipped and not self.field_known:
                    # both skipped: 7.4.4 inference, applied retroactively
                    self.cur_field = self.eff_field = self._predict_field()
                    self.field_known = True
                    self.pic.field[self.mby - 1, self.mbx] = self.cur_field
                    self.pic.field[self.mby, self.mbx] = self.cur_field
                n += 1
            if mb_count is None:
                eos = self.c.cabac_terminate_eos()
            else:
                eos = 1 if n == mb_count else 0
                self.c.cabac_terminate_eos_put(eos)
            if eos:
                break
            pair += 1
        self.mb_count = n
        return n
