"""Slice header parsing (clause 7.3.3) up to the start of CABAC slice data.

The header bits are stored verbatim in the container (they are plain
exp-golomb, already near-optimal); parsing serves two purposes:
  1. extract the fields the CABAC parser needs (slice_type, cabac_init_idc,
     SliceQP, active ref counts, first_mb_in_slice), and
  2. find the exact bit offset where cabac_alignment_one_bit ends, i.e. the
     byte where the CABAC payload begins inside the RBSP.
"""

from dataclasses import dataclass

from ..utils.bitio import BitReader
from .params import UnsupportedStream

# slice_type % 5
SLICE_P, SLICE_B, SLICE_I, SLICE_SP, SLICE_SI = 0, 1, 2, 3, 4


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = 0  # already reduced mod 5
    pps_id: int = 0
    frame_num: int = 0
    idr: bool = False
    cabac_init_idc: int = 0
    slice_qp: int = 26
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    direct_spatial_mv_pred_flag: int = 0
    mbaff: bool = False  # MB-adaptive frame/field frame picture
    field_pic: bool = False  # PAFF field picture (all MBs field-coded)
    bottom_field: bool = False
    colour_plane_id: int = 0  # separate_colour_plane_flag streams
    cabac_start_byte: int = 0  # offset into unescaped RBSP where CABAC begins
    cavlc: bool = False  # entropy_coding_mode_flag == 0 (CAVLC slice data)
    data_bit_offset: int = 0  # CAVLC: RBSP bit position where slice_data begins


def parse_slice_header(rbsp, nal_type, nal_ref_idc, sps_map, pps_map):
    """Parse the header of a coded-slice NAL's unescaped RBSP.

    rbsp excludes the NAL header byte. Returns (SliceHeader, sps, pps).
    """
    r = BitReader(rbsp)
    h = SliceHeader()
    h.idr = nal_type == 5
    h.first_mb_in_slice = r.ue()
    st = r.ue()
    h.slice_type = st % 5
    h.pps_id = r.ue()
    pps = pps_map.get(h.pps_id)
    if pps is None:
        raise UnsupportedStream(f"unknown PPS {h.pps_id}")
    sps = sps_map.get(pps.sps_id)
    if sps is None:
        raise UnsupportedStream(f"unknown SPS {pps.sps_id}")
    h.cavlc = not pps.entropy_coding_mode_flag
    if sps.chroma_format_idc not in (0, 1, 2, 3):
        raise UnsupportedStream(f"chroma_format_idc {sps.chroma_format_idc}")
    if sps.separate_colour_plane_flag:
        h.colour_plane_id = r.u(2)  # 7.3.3: each plane codes separately
        if h.colour_plane_id > 2:
            raise UnsupportedStream("bad colour_plane_id")
    h.frame_num = r.u(sps.log2_max_frame_num)
    if not sps.frame_mbs_only_flag:
        if r.flag():  # field_pic_flag: individual field picture (PAFF)
            h.field_pic = True
            h.bottom_field = bool(r.flag())
        else:
            # MBAFF frame iff the SPS says mb_adaptive (a PAFF stream's
            # frame pictures are plain frames otherwise)
            h.mbaff = bool(sps.mb_adaptive_frame_field_flag)
    if h.idr:
        r.ue()  # idr_pic_id
    if sps.pic_order_cnt_type == 0:
        r.u(sps.log2_max_pic_order_cnt_lsb)
        if pps.bottom_field_pic_order_in_frame_present_flag and not h.field_pic:
            r.se()  # delta_pic_order_cnt_bottom
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero_flag:
        r.se()
        if pps.bottom_field_pic_order_in_frame_present_flag and not h.field_pic:
            r.se()
    if pps.redundant_pic_cnt_present_flag:
        if r.ue() != 0:
            raise UnsupportedStream("redundant slices")

    h.num_ref_idx_l0_active = pps.num_ref_idx_l0_default_active
    h.num_ref_idx_l1_active = pps.num_ref_idx_l1_default_active
    if h.slice_type == SLICE_B:
        h.direct_spatial_mv_pred_flag = r.flag()
    if h.slice_type in (SLICE_P, SLICE_SP, SLICE_B):
        if r.flag():  # num_ref_idx_active_override
            h.num_ref_idx_l0_active = r.ue() + 1
            if h.slice_type == SLICE_B:
                h.num_ref_idx_l1_active = r.ue() + 1

    # ref_pic_list_modification (7.3.3.1)
    if h.slice_type in (SLICE_P, SLICE_SP, SLICE_B):
        if r.flag():
            while True:
                op = r.ue()
                if op == 3:
                    break
                r.ue()  # abs_diff_pic_num / long_term_pic_num
    if h.slice_type == SLICE_B:
        if r.flag():
            while True:
                op = r.ue()
                if op == 3:
                    break
                r.ue()

    # pred_weight_table (7.3.3.2)
    if (pps.weighted_pred_flag and h.slice_type in (SLICE_P, SLICE_SP)) or (
        pps.weighted_bipred_idc == 1 and h.slice_type == SLICE_B
    ):
        r.ue()  # luma_log2_weight_denom
        r.ue()  # chroma_log2_weight_denom
        for nref in (
            [h.num_ref_idx_l0_active]
            + ([h.num_ref_idx_l1_active] if h.slice_type == SLICE_B else [])
        ):
            for _ in range(nref):
                if r.flag():
                    r.se()
                    r.se()
                if r.flag():
                    for _ in range(2):
                        r.se()
                        r.se()

    # dec_ref_pic_marking (7.3.3.3)
    if nal_ref_idc != 0:
        if h.idr:
            r.flag()  # no_output_of_prior_pics
            r.flag()  # long_term_reference_flag
        else:
            if r.flag():  # adaptive_ref_pic_marking_mode
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    if op in (1, 3):
                        r.ue()
                    if op in (2,):
                        r.ue()
                    if op in (3, 6):
                        r.ue()
                    if op == 4:
                        r.ue()

    # 7.3.3: cabac_init_idc present only for CABAC P/SP/B slices
    if not h.cavlc and h.slice_type not in (SLICE_I, SLICE_SI):
        h.cabac_init_idc = r.ue()
        if h.cabac_init_idc > 2:
            raise UnsupportedStream("bad cabac_init_idc")
    h.slice_qp = pps.pic_init_qp + r.se()
    if h.slice_type in (SLICE_SP, SLICE_SI):
        if h.slice_type == SLICE_SP:
            r.flag()  # sp_for_switch_flag
        r.se()  # slice_qs_delta (reconstruction-only; parse is unaffected)
    if pps.deblocking_filter_control_present_flag:
        idc = r.ue()
        if idc != 1:
            r.se()
            r.se()
    # num_slice_groups == 1 enforced at PPS parse; no slice_group_change_cycle

    if h.cavlc:
        # CAVLC slice data starts at the current (unaligned) bit; the
        # container head spans THROUGH the partial byte so the header
        # stays parseable, and regeneration re-produces that byte
        h.data_bit_offset = r.bitpos
        h.cabac_start_byte = (r.bitpos + 7) >> 3
        return h, sps, pps
    # cabac_alignment_one_bit: 1-bits until byte aligned (7.3.4)
    while not r.byte_aligned():
        if r.u(1) != 1:
            raise UnsupportedStream("bad cabac_alignment_one_bit")
    h.cabac_start_byte = r.bitpos >> 3
    h.data_bit_offset = r.bitpos
    return h, sps, pps
