"""SPS / PPS parsing (ITU-T H.264 clauses 7.3.2.1, 7.3.2.2).

Parameter-set NALs are carried as literals in the recoded container; they are
parsed only to extract the fields the CABAC slice parser needs.  The
reference obtains all of this implicitly from ffmpeg's decoder state
(SURVEY.md L0/C5); here it is owned, explicit state.
"""

from dataclasses import dataclass, field

from ..utils.bitio import BitReader, unescape_rbsp


class UnsupportedStream(Exception):
    """Raised when a stream feature outside the recoder's parse scope is hit.

    The compressor catches this and falls back to literal passthrough for the
    affected slices (the skip_coded analog, recode.cpp:1296-1303), so
    roundtrip correctness never depends on parse coverage."""


@dataclass
class SPS:
    profile_idc: int = 0
    level_idc: int = 0
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: int = 0
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass_flag: int = 0
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb: int = 4
    delta_pic_order_always_zero_flag: int = 0
    max_num_ref_frames: int = 1
    pic_width_in_mbs: int = 0
    pic_height_in_map_units: int = 0
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    entropy_coding_mode_flag: int = 0
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_slice_groups: int = 1
    num_ref_idx_l0_default_active: int = 1
    num_ref_idx_l1_default_active: int = 1
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    transform_8x8_mode_flag: int = 0


def mb_height(sps):
    """Picture height in MB rows: map units are MB-pair rows for MBAFF
    (clause 7.4.2.1.1 FrameHeightInMbs)."""
    return sps.pic_height_in_map_units * (1 if sps.frame_mbs_only_flag else 2)


def _skip_scaling_list(r, size):
    last_scale, next_scale = 8, 8
    for _ in range(size):
        if next_scale != 0:
            delta = r.se()
            next_scale = (last_scale + delta + 256) % 256
        if next_scale != 0:
            last_scale = next_scale


def parse_sps(nal_payload):
    """nal_payload: full NAL bytes including the header byte (type 7)."""
    rbsp = unescape_rbsp(nal_payload[1:])
    r = BitReader(rbsp)
    s = SPS()
    s.profile_idc = r.u(8)
    r.u(8)  # constraint flags + reserved
    s.level_idc = r.u(8)
    s.sps_id = r.ue()
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        s.chroma_format_idc = r.ue()
        if s.chroma_format_idc == 3:
            s.separate_colour_plane_flag = r.flag()
        s.bit_depth_luma = r.ue() + 8
        s.bit_depth_chroma = r.ue() + 8
        s.qpprime_y_zero_transform_bypass_flag = r.flag()
        if r.flag():  # seq_scaling_matrix_present
            n_lists = 8 if s.chroma_format_idc != 3 else 12
            for i in range(n_lists):
                if r.flag():
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    s.log2_max_frame_num = r.ue() + 4
    s.pic_order_cnt_type = r.ue()
    if s.pic_order_cnt_type == 0:
        s.log2_max_pic_order_cnt_lsb = r.ue() + 4
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero_flag = r.flag()
        r.se()  # offset_for_non_ref_pic
        r.se()  # offset_for_top_to_bottom_field
        for _ in range(r.ue()):
            r.se()
    s.max_num_ref_frames = r.ue()
    r.flag()  # gaps_in_frame_num_value_allowed
    s.pic_width_in_mbs = r.ue() + 1
    s.pic_height_in_map_units = r.ue() + 1
    s.frame_mbs_only_flag = r.flag()
    if not s.frame_mbs_only_flag:
        s.mb_adaptive_frame_field_flag = r.flag()
    s.direct_8x8_inference_flag = r.flag()
    # cropping + VUI not needed
    return s


def parse_pps(nal_payload, sps_map):
    rbsp = unescape_rbsp(nal_payload[1:])
    r = BitReader(rbsp)
    p = PPS()
    p.pps_id = r.ue()
    p.sps_id = r.ue()
    p.entropy_coding_mode_flag = r.flag()
    p.bottom_field_pic_order_in_frame_present_flag = r.flag()
    p.num_slice_groups = r.ue() + 1
    if p.num_slice_groups > 1:
        # FMO: outside parse scope (also absent from High profile)
        raise UnsupportedStream("slice groups (FMO)")
    p.num_ref_idx_l0_default_active = r.ue() + 1
    p.num_ref_idx_l1_default_active = r.ue() + 1
    p.weighted_pred_flag = r.flag()
    p.weighted_bipred_idc = r.u(2)
    p.pic_init_qp = r.se() + 26
    r.se()  # pic_init_qs
    p.chroma_qp_index_offset = r.se()
    p.deblocking_filter_control_present_flag = r.flag()
    p.constrained_intra_pred_flag = r.flag()
    p.redundant_pic_cnt_present_flag = r.flag()
    if r.more_rbsp_data():
        p.transform_8x8_mode_flag = r.flag()
        if r.flag():  # pic_scaling_matrix_present
            sps = sps_map.get(p.sps_id)
            chroma3 = sps is not None and sps.chroma_format_idc == 3
            n_lists = 6 + (6 if chroma3 else 2) * p.transform_8x8_mode_flag
            for i in range(n_lists):
                if r.flag():
                    _skip_scaling_list(r, 16 if i < 6 else 64)
        r.se()  # second_chroma_qp_index_offset
    return p
