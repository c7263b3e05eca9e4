// Container demux + SPS/PPS/slice-header parsing — C++ mirror of
// utils/mp4.py, h264/params.py, h264/slicehdr.py.
#pragma once
#include <cstdint>
#include <cstring>
#include <map>
#include <optional>
#include <vector>
#include "bitio.h"

namespace avtpu {

struct NalSpan {
  uint64_t offset;
  uint64_t size;  // total NAL byte length (sum of segments for MPEG-TS)
  int nal_type;
  int nal_ref_idc;
  // non-contiguous NALs (MPEG-TS): (file_offset, length) pieces whose
  // lengths sum to `size`; empty = contiguous at [offset, offset+size)
  std::vector<std::pair<uint64_t, uint64_t>> segs;
};

inline Bytes nal_payload(const uint8_t* data, const NalSpan& n) {
  if (n.segs.empty()) return Bytes(data + n.offset, data + n.offset + n.size);
  Bytes out;
  out.reserve(n.size);
  for (auto& [o, l] : n.segs) out.insert(out.end(), data + o, data + o + l);
  return out;
}

inline uint64_t nal_span_end(const NalSpan& n) {
  if (n.segs.empty()) return n.offset + n.size;
  return n.segs.back().first + n.segs.back().second;
}

struct H264Stream {
  std::vector<Bytes> sps_list, pps_list;
  std::vector<NalSpan> nals;
};

// ---------------------------------------------------------------- params --
struct SPS {
  int profile_idc = 0, level_idc = 0, sps_id = 0;
  int chroma_format_idc = 1, separate_colour_plane_flag = 0;
  int bit_depth_luma = 8, bit_depth_chroma = 8;
  int log2_max_frame_num = 4, pic_order_cnt_type = 0;
  int log2_max_pic_order_cnt_lsb = 4, delta_pic_order_always_zero_flag = 0;
  int max_num_ref_frames = 1;
  int pic_width_in_mbs = 0, pic_height_in_map_units = 0;
  int frame_mbs_only_flag = 1, mb_adaptive_frame_field_flag = 0;
  int direct_8x8_inference_flag = 1;
};

struct PPS {
  int pps_id = 0, sps_id = 0;
  int entropy_coding_mode_flag = 0;
  int bottom_field_pic_order_in_frame_present_flag = 0;
  int num_slice_groups = 1;
  int num_ref_idx_l0_default_active = 1, num_ref_idx_l1_default_active = 1;
  int weighted_pred_flag = 0, weighted_bipred_idc = 0;
  int pic_init_qp = 26, chroma_qp_index_offset = 0;
  int deblocking_filter_control_present_flag = 0;
  int constrained_intra_pred_flag = 0, redundant_pic_cnt_present_flag = 0;
  int transform_8x8_mode_flag = 0;
};

enum { SLICE_P = 0, SLICE_B = 1, SLICE_I = 2, SLICE_SP = 3, SLICE_SI = 4 };

// picture height in MB rows: map units are MB-pair rows for MBAFF (7.4.2.1.1)
inline int mb_height(const SPS& s) {
  return s.pic_height_in_map_units * (s.frame_mbs_only_flag ? 1 : 2);
}

struct SliceHeader {
  int first_mb_in_slice = 0, slice_type = 0, pps_id = 0, frame_num = 0;
  bool idr = false;
  bool mbaff = false;  // MB-adaptive frame/field frame picture
  bool field_pic = false;  // PAFF field picture (all MBs field-coded)
  bool bottom_field = false;
  int colour_plane_id = 0;  // separate_colour_plane_flag streams
  int cabac_init_idc = 0, slice_qp = 26;
  int num_ref_idx_l0_active = 1, num_ref_idx_l1_active = 1;
  int direct_spatial_mv_pred_flag = 0;
  size_t cabac_start_byte = 0;  // into unescaped RBSP (after NAL hdr byte)
  bool cavlc = false;           // entropy_coding_mode_flag == 0
  size_t data_bit_offset = 0;   // CAVLC: RBSP bit where slice_data begins
};

inline void skip_scaling_list(BitReader& r, int size) {
  int last = 8, next = 8;
  for (int i = 0; i < size; i++) {
    if (next != 0) next = (last + r.se() + 256) % 256;
    if (next != 0) last = next;
  }
}

inline SPS parse_sps(const Bytes& nal) {
  Bytes rbsp = unescape_rbsp(nal.data() + 1, nal.size() - 1);
  BitReader r(rbsp.data(), rbsp.size());
  SPS s;
  s.profile_idc = r.u(8);
  r.u(8);
  s.level_idc = r.u(8);
  s.sps_id = r.ue();
  switch (s.profile_idc) {
    case 100: case 110: case 122: case 244: case 44: case 83: case 86:
    case 118: case 128: case 138: case 139: case 134: case 135: {
      s.chroma_format_idc = r.ue();
      if (s.chroma_format_idc == 3) s.separate_colour_plane_flag = r.flag();
      s.bit_depth_luma = r.ue() + 8;
      s.bit_depth_chroma = r.ue() + 8;
      r.flag();  // qpprime_y_zero_transform_bypass
      if (r.flag()) {
        int n_lists = s.chroma_format_idc != 3 ? 8 : 12;
        for (int i = 0; i < n_lists; i++)
          if (r.flag()) skip_scaling_list(r, i < 6 ? 16 : 64);
      }
      break;
    }
    default:
      break;
  }
  s.log2_max_frame_num = r.ue() + 4;
  s.pic_order_cnt_type = r.ue();
  if (s.pic_order_cnt_type == 0) {
    s.log2_max_pic_order_cnt_lsb = r.ue() + 4;
  } else if (s.pic_order_cnt_type == 1) {
    s.delta_pic_order_always_zero_flag = r.flag();
    r.se();
    r.se();
    int n = r.ue();
    for (int i = 0; i < n; i++) r.se();
  }
  s.max_num_ref_frames = r.ue();
  r.flag();
  s.pic_width_in_mbs = r.ue() + 1;
  s.pic_height_in_map_units = r.ue() + 1;
  s.frame_mbs_only_flag = r.flag();
  if (!s.frame_mbs_only_flag) s.mb_adaptive_frame_field_flag = r.flag();
  s.direct_8x8_inference_flag = r.flag();
  return s;
}

inline PPS parse_pps(const Bytes& nal, const std::map<int, SPS>& sps_map) {
  Bytes rbsp = unescape_rbsp(nal.data() + 1, nal.size() - 1);
  BitReader r(rbsp.data(), rbsp.size());
  PPS p;
  p.pps_id = r.ue();
  p.sps_id = r.ue();
  p.entropy_coding_mode_flag = r.flag();
  p.bottom_field_pic_order_in_frame_present_flag = r.flag();
  p.num_slice_groups = r.ue() + 1;
  if (p.num_slice_groups > 1) throw Unsupported("slice groups (FMO)");
  p.num_ref_idx_l0_default_active = r.ue() + 1;
  p.num_ref_idx_l1_default_active = r.ue() + 1;
  p.weighted_pred_flag = r.flag();
  p.weighted_bipred_idc = r.u(2);
  p.pic_init_qp = r.se() + 26;
  r.se();
  p.chroma_qp_index_offset = r.se();
  p.deblocking_filter_control_present_flag = r.flag();
  p.constrained_intra_pred_flag = r.flag();
  p.redundant_pic_cnt_present_flag = r.flag();
  if (r.more_rbsp_data()) {
    p.transform_8x8_mode_flag = r.flag();
    if (r.flag()) {
      auto it = sps_map.find(p.sps_id);
      bool chroma3 = it != sps_map.end() && it->second.chroma_format_idc == 3;
      int n_lists = 6 + (chroma3 ? 6 : 2) * p.transform_8x8_mode_flag;
      for (int i = 0; i < n_lists; i++)
        if (r.flag()) skip_scaling_list(r, i < 6 ? 16 : 64);
    }
    r.se();  // second_chroma_qp_index_offset
  }
  return p;
}

// Returns header; throws Unsupported on out-of-scope features.
inline SliceHeader parse_slice_header(const Bytes& rbsp, int nal_type,
                                      int nal_ref_idc,
                                      const std::map<int, SPS>& sps_map,
                                      const std::map<int, PPS>& pps_map,
                                      SPS* sps_out, PPS* pps_out) {
  BitReader r(rbsp.data(), rbsp.size());
  SliceHeader h;
  h.idr = nal_type == 5;
  h.first_mb_in_slice = r.ue();
  h.slice_type = (int)(r.ue() % 5);
  h.pps_id = r.ue();
  auto pit = pps_map.find(h.pps_id);
  if (pit == pps_map.end()) throw Unsupported("unknown PPS");
  const PPS& pps = pit->second;
  auto sit = sps_map.find(pps.sps_id);
  if (sit == sps_map.end()) throw Unsupported("unknown SPS");
  const SPS& sps = sit->second;
  h.cavlc = !pps.entropy_coding_mode_flag;
  if (sps.chroma_format_idc < 0 || sps.chroma_format_idc > 3)
    throw Unsupported("chroma format");
  if (sps.separate_colour_plane_flag) {
    h.colour_plane_id = (int)r.u(2);  // 7.3.3: each plane codes separately
    if (h.colour_plane_id > 2) throw Unsupported("bad colour_plane_id");
  }
  h.frame_num = r.u(sps.log2_max_frame_num);
  if (!sps.frame_mbs_only_flag) {
    if (r.flag()) {  // field_pic_flag: individual field picture (PAFF)
      h.field_pic = true;
      h.bottom_field = r.flag();
    } else {
      // MBAFF frame iff the SPS says mb_adaptive
      h.mbaff = sps.mb_adaptive_frame_field_flag != 0;
    }
  }
  if (h.idr) r.ue();
  if (sps.pic_order_cnt_type == 0) {
    r.u(sps.log2_max_pic_order_cnt_lsb);
    if (pps.bottom_field_pic_order_in_frame_present_flag && !h.field_pic)
      r.se();
  } else if (sps.pic_order_cnt_type == 1 &&
             !sps.delta_pic_order_always_zero_flag) {
    r.se();
    if (pps.bottom_field_pic_order_in_frame_present_flag && !h.field_pic)
      r.se();
  }
  if (pps.redundant_pic_cnt_present_flag && r.ue() != 0)
    throw Unsupported("redundant slices");

  h.num_ref_idx_l0_active = pps.num_ref_idx_l0_default_active;
  h.num_ref_idx_l1_active = pps.num_ref_idx_l1_default_active;
  if (h.slice_type == SLICE_B) h.direct_spatial_mv_pred_flag = r.flag();
  if (h.slice_type == SLICE_P || h.slice_type == SLICE_SP ||
      h.slice_type == SLICE_B) {
    if (r.flag()) {
      h.num_ref_idx_l0_active = r.ue() + 1;
      if (h.slice_type == SLICE_B) h.num_ref_idx_l1_active = r.ue() + 1;
    }
  }
  if (h.slice_type == SLICE_P || h.slice_type == SLICE_SP ||
      h.slice_type == SLICE_B) {
    if (r.flag())
      while (r.ue() != 3) r.ue();
  }
  if (h.slice_type == SLICE_B) {
    if (r.flag())
      while (r.ue() != 3) r.ue();
  }
  if ((pps.weighted_pred_flag &&
       (h.slice_type == SLICE_P || h.slice_type == SLICE_SP)) ||
      (pps.weighted_bipred_idc == 1 && h.slice_type == SLICE_B)) {
    r.ue();
    r.ue();
    int lists = h.slice_type == SLICE_B ? 2 : 1;
    for (int l = 0; l < lists; l++) {
      int nref = l == 0 ? h.num_ref_idx_l0_active : h.num_ref_idx_l1_active;
      for (int i = 0; i < nref; i++) {
        if (r.flag()) {
          r.se();
          r.se();
        }
        if (r.flag())
          for (int j = 0; j < 2; j++) {
            r.se();
            r.se();
          }
      }
    }
  }
  if (nal_ref_idc != 0) {
    if (h.idr) {
      r.flag();
      r.flag();
    } else if (r.flag()) {
      for (;;) {
        uint32_t op = r.ue();
        if (op == 0) break;
        if (op == 1 || op == 3) r.ue();
        if (op == 2) r.ue();
        if (op == 3 || op == 6) r.ue();
        if (op == 4) r.ue();
      }
    }
  }
  // 7.3.3: cabac_init_idc present only for CABAC P/SP/B slices
  if (!h.cavlc && h.slice_type != SLICE_I && h.slice_type != SLICE_SI) {
    h.cabac_init_idc = r.ue();
    if (h.cabac_init_idc > 2) throw Unsupported("bad cabac_init_idc");
  }
  h.slice_qp = pps.pic_init_qp + r.se();
  if (h.slice_type == SLICE_SP || h.slice_type == SLICE_SI) {
    if (h.slice_type == SLICE_SP) r.flag();  // sp_for_switch_flag
    r.se();  // slice_qs_delta (reconstruction-only)
  }
  if (pps.deblocking_filter_control_present_flag) {
    uint32_t idc = r.ue();
    if (idc != 1) {
      r.se();
      r.se();
    }
  }
  if (h.cavlc) {
    // CAVLC slice data starts at the current (unaligned) bit; the
    // container head spans THROUGH the partial byte so the header stays
    // parseable, and regeneration re-produces that byte (cavlc.h)
    h.data_bit_offset = r.bitpos();
    h.cabac_start_byte = (r.bitpos() + 7) >> 3;
    *sps_out = sps;
    *pps_out = pps;
    return h;
  }
  while (!r.byte_aligned())
    if (r.u(1) != 1) throw Unsupported("bad cabac_alignment_one_bit");
  h.cabac_start_byte = r.bitpos() >> 3;
  h.data_bit_offset = r.bitpos();
  *sps_out = sps;
  *pps_out = pps;
  return h;
}

// ----------------------------------------------------------------- demux --
namespace mp4 {

inline uint32_t rd32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}
inline uint64_t rd64(const uint8_t* p) {
  return ((uint64_t)rd32(p) << 32) | rd32(p + 4);
}
inline uint16_t rd16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }

struct Box {
  const char* type;
  uint64_t body_s, body_e;
};

template <typename F>
inline void for_boxes(const uint8_t* d, uint64_t s, uint64_t e, F f) {
  uint64_t pos = s;
  while (pos + 8 <= e) {
    uint64_t size = rd32(d + pos);
    const uint8_t* btype = d + pos + 4;
    uint64_t hdr = 8;
    if (size == 1) {
      if (pos + 16 > e) break;
      size = rd64(d + pos + 8);
      hdr = 16;
    } else if (size == 0) {
      size = e - pos;
    }
    if (size < hdr || pos + size > e) break;
    if (!f(btype, pos + hdr, pos + size)) return;
    pos += size;
  }
}

inline bool find_box(const uint8_t* d, uint64_t s, uint64_t e,
                     const std::vector<std::string>& path, size_t depth,
                     uint64_t* out_s, uint64_t* out_e) {
  if (depth == path.size()) {
    *out_s = s;
    *out_e = e;
    return true;
  }
  bool found = false;
  for_boxes(d, s, e, [&](const uint8_t* t, uint64_t bs, uint64_t be) {
    if (!found && memcmp(t, path[depth].data(), 4) == 0) {
      if (find_box(d, bs, be, path, depth + 1, out_s, out_e)) found = true;
    }
    return !found;
  });
  return found;
}

}  // namespace mp4

std::optional<H264Stream> demux(const uint8_t* data, size_t size);

}  // namespace avtpu
