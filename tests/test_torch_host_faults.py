"""Two faults of the host layer, repaired in the port's copy only (the JAX
package keeps its behaviour and stays the reference elsewhere):

- an AVI whose movi LIST groups its chunks in nested `rec ` LISTs is
  walked in file order by both of the port's demuxers (utils/avi.py and
  host/src/demux.cc), so its NAL units keep their order;
- a CAVLC ue() prefix of more than 31 zeros is refused by both of the
  port's parsers (h264/cavlc.py and host/src/cavlc.h), so the slice stays
  literal in both containers alike.

Tolerance: exact equality of containers and decoded bytes."""

import os
import struct

import pytest

from avrecode_tpu_torch import codec as pcodec
from avrecode_tpu_torch.host import native as pnative
from avrecode_tpu_torch.utils.bitio import BitWriter, escape_rbsp
from avrecode_tpu_torch.utils.avi import demux_avi
from avrecode_tpu_torch.utils.container import KIND_SLICE
from avrecode_tpu_torch.utils.mp4 import NalSpan, nal_payload

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _needs_native():
    if not pnative.available():
        pytest.skip("native library not built")


def _chunk(ckid, body):
    return ckid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _riff_chunks(data, pos, end):
    while pos + 8 <= end:
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        yield data[pos:pos + 4], pos + 8, pos + 8 + size
        pos += 8 + size + (size & 1)


def rec_grouped_avi():
    """data/rt_ctr.avi with its movi chunks regrouped: ten chunks directly
    in movi, then two `rec ` LISTs holding the rest."""
    with open(os.path.join(DATA, "rt_ctr.avi"), "rb") as f:
        data = f.read()
    body = b""
    for ckid, s, e in _riff_chunks(data, 12, len(data)):
        if ckid == b"LIST" and data[s:s + 4] == b"movi":
            kids = [_chunk(c, data[cs:ce])
                    for c, cs, ce in _riff_chunks(data, s + 4, e)]
            half = (len(kids) + 10) // 2
            movi = (b"movi" + b"".join(kids[:10])
                    + _chunk(b"LIST", b"rec " + b"".join(kids[10:half]))
                    + _chunk(b"LIST", b"rec " + b"".join(kids[half:])))
            body += _chunk(b"LIST", movi)
        else:
            body += _chunk(ckid, data[s:e])
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body


def _slice_blocks(data, scope):
    """The native extractor's slice blocks in order, each with the bins
    and probabilities of its trace (gop continuations carry none)."""
    blocks = pnative.extract(data, scope, want_slots=False)[2]
    return [blk[1:6] + (blk[7], blk[6].recs32().tobytes() if blk[6] else b"")
            for blk in blocks if blk[0] == KIND_SLICE]


@pytest.mark.parametrize("scope", ["slice", "gop"])
def test_avi_rec_lists_in_file_order(scope):
    """Both demuxers give the NAL payloads of a rec-grouped AVI in the
    plain AVI's order; both coders recode its slices (the container is as
    small as the plain AVI's), agree byte for byte, and decode it back."""
    _needs_native()
    data = rec_grouped_avi()
    with open(os.path.join(DATA, "rt_ctr.avi"), "rb") as f:
        plain_data = f.read()
    spans = demux_avi(data, NalSpan)[2]
    assert [s.offset for s in spans] == sorted(s.offset for s in spans)
    assert [nal_payload(data, s) for s in spans] == [
        nal_payload(plain_data, s) for s in demux_avi(plain_data, NalSpan)[2]]
    assert _slice_blocks(data, scope) == _slice_blocks(plain_data, scope)
    plain = pcodec.compress(plain_data, scope=scope)
    out = pcodec.compress(data, scope=scope)
    assert out == pnative.compress(data, scope=scope)
    assert len(out) < len(plain) + 64
    assert pcodec.decompress(out) == data
    assert pnative.decompress(out) == data


def _trail(w):
    w.u(1, 1)  # rbsp_stop_one_bit
    w.align_with(0)
    return w.bytes()


def cavlc_stream(prefix_zeros, suffix, mbs=4):
    """Annex-B baseline (CAVLC) stream of one IDR picture of mbs x mbs
    I_16x16 macroblocks without residual; the first one's mb_type is coded
    as a ue() of `prefix_zeros` leading zeros and the suffix bits `suffix`,
    the others' as ue(1).  Returns (stream, the slice NAL)."""
    sps = BitWriter()
    sps.u(66, 8)  # profile_idc baseline
    sps.u(0, 8)  # constraint flags
    sps.u(30, 8)  # level
    sps.ue(0)  # sps_id
    sps.ue(0)  # log2_max_frame_num_minus4
    sps.ue(2)  # pic_order_cnt_type 2
    sps.ue(1)  # max_num_ref_frames
    sps.u(0, 1)  # gaps allowed
    sps.ue(mbs - 1)  # pic_width_in_mbs_minus1
    sps.ue(mbs - 1)  # pic_height_in_map_units_minus1
    sps.u(1, 1)  # frame_mbs_only
    sps.u(1, 1)  # direct_8x8_inference
    sps.u(0, 1)  # frame_cropping
    sps.u(0, 1)  # vui
    pps = BitWriter()
    pps.ue(0)  # pps_id
    pps.ue(0)  # sps_id
    pps.u(0, 1)  # entropy_coding_mode = CAVLC
    pps.u(0, 1)  # bottom_field_pic_order
    pps.ue(0)  # num_slice_groups_minus1
    pps.ue(0)  # num_ref_idx_l0_default_minus1
    pps.ue(0)  # l1
    pps.u(0, 1)  # weighted_pred
    pps.u(0, 2)  # weighted_bipred
    pps.se(0)  # pic_init_qp_minus26
    pps.se(0)  # pic_init_qs
    pps.se(0)  # chroma_qp_offset
    pps.u(0, 1)  # deblocking_control_present
    pps.u(0, 1)  # constrained_intra
    pps.u(0, 1)  # redundant_pic_cnt_present
    sl = BitWriter()
    sl.ue(0)  # first_mb_in_slice
    sl.ue(7)  # slice_type I
    sl.ue(0)  # pps_id
    sl.u(0, 4)  # frame_num
    sl.ue(0)  # idr_pic_id
    sl.u(0, 1)  # no_output_of_prior_pics
    sl.u(0, 1)  # long_term_reference
    sl.se(0)  # slice_qp_delta
    for mb in range(mbs * mbs):
        if mb == 0:
            sl.u(0, prefix_zeros)
            sl.u(1, 1)
            for bit in suffix:
                sl.u(bit, 1)
        else:
            sl.ue(1)  # mb_type I_16x16_0_0_0
        sl.ue(0)  # intra_chroma_pred_mode
        sl.se(0)  # mb_qp_delta
        sl.u(1, 1)  # Intra16x16DCLevel coeff_token: no coefficient (nC 0)
    nal = bytes([0x65]) + escape_rbsp(_trail(sl))
    sc = b"\0\0\0\1"
    stream = (sc + bytes([0x67]) + escape_rbsp(_trail(sps))
              + sc + bytes([0x68]) + escape_rbsp(_trail(pps)) + sc + nal)
    return stream, nal


def _bits(value, n):
    return [(value >> (n - 1 - i)) & 1 for i in range(n)]


@pytest.mark.parametrize("scope", ["slice", "gop"])
def test_cavlc_long_ue_prefix_refused_alike(scope):
    """mb_type 1 coded as a ue() with 40 leading zeros: its value,
    2^40 - 1 + suffix, leaves 32 bits.  The suffix is chosen so that a
    parser that wraps at 32 bits reads mb_type 1 and parses on; both of
    the port's parsers refuse it instead, so the slice stays literal in
    both containers, which agree and decode back.  The same slice with
    mb_type 1 coded in 3 bits recodes in both."""
    _needs_native()
    good, good_nal = cavlc_stream(1, [0])
    out = pcodec.compress(good, scope=scope)
    assert out == pnative.compress(good, scope=scope)
    assert good_nal not in out  # recoded, not literal
    assert pcodec.decompress(out) == good

    # 255 + suffix = 1 mod 2^32, where 1u << 40 wraps to 1 << 8
    bad, bad_nal = cavlc_stream(40, _bits(0xAB00000000 + 0xFFFFFF02, 40))
    out = pcodec.compress(bad, scope=scope)
    assert out == pnative.compress(bad, scope=scope)
    assert bad_nal in out  # refused: the slice is a literal
    assert pcodec.decompress(out) == bad
    assert pnative.decompress(out) == bad
