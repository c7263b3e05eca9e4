// ISO-BMFF / Annex-B demux — C++ mirror of utils/mp4.py.
#include <algorithm>

#include "h264.h"

namespace avtpu {

using mp4::find_box;
using mp4::for_boxes;
using mp4::rd16;
using mp4::rd32;
using mp4::rd64;

static Bytes parse_avcc_field(const uint8_t* p, size_t len, int* length_size,
                              std::vector<Bytes>* sps, std::vector<Bytes>* pps) {
  if (len < 7 || p[0] != 1) throw ParseError("bad avcC");
  *length_size = (p[4] & 3) + 1;
  size_t pos = 5;
  int n_sps = p[pos++] & 0x1F;
  for (int i = 0; i < n_sps; i++) {
    if (pos + 2 > len) throw ParseError("avcC sps");
    int ln = rd16(p + pos);
    pos += 2;
    if (pos + ln > len) throw ParseError("avcC sps");
    sps->emplace_back(p + pos, p + pos + ln);
    pos += ln;
  }
  if (pos >= len) throw ParseError("avcC pps");
  int n_pps = p[pos++];
  for (int i = 0; i < n_pps; i++) {
    if (pos + 2 > len) throw ParseError("avcC pps");
    int ln = rd16(p + pos);
    pos += 2;
    if (pos + ln > len) throw ParseError("avcC pps");
    pps->emplace_back(p + pos, p + pos + ln);
    pos += ln;
  }
  return {};
}

// tkhd track_id (0 if absent)
static uint32_t track_id_of(const uint8_t* d, uint64_t trak_s,
                            uint64_t trak_e) {
  uint64_t s, e;
  if (!find_box(d, trak_s, trak_e, {"tkhd"}, 0, &s, &e)) return 0;
  if (s >= e) return 0;
  uint64_t off = s + 4 + (d[s] ? 16 : 8);  // ver/flags + ctime + mtime
  if (off + 4 > e) return 0;
  return rd32(d + off);
}

// mvex/trex default_sample_size for track_id (0 if none)
static uint32_t trex_size_of(const uint8_t* d, uint64_t moov_s,
                             uint64_t moov_e, uint32_t tid) {
  uint64_t mvex_s, mvex_e;
  if (!find_box(d, moov_s, moov_e, {"mvex"}, 0, &mvex_s, &mvex_e)) return 0;
  uint32_t out = 0;
  for_boxes(d, mvex_s, mvex_e, [&](const uint8_t* t, uint64_t s, uint64_t e) {
    if (memcmp(t, "trex", 4) || s + 20 > e) return true;
    if (rd32(d + s + 4) == tid) {
      out = rd32(d + s + 16);
      return false;
    }
    return true;
  });
  return out;
}

// fragmented MP4 (DASH/CMAF): walk top-level moof boxes -> (offset, size)
// per sample in file order; mirrors utils/mp4.py::_fragment_samples.
// Covers what the reference gets from libavformat (recode.cpp:89-96):
// tfhd base_data_offset / default-base-is-moof / implicit moof-start base,
// tfhd+trex default sizes, multi-trun trafs with continuation offsets.
static void fragment_samples(const uint8_t* d, size_t n, uint32_t tid,
                             uint32_t trex_size,
                             std::vector<std::pair<uint64_t, uint64_t>>* out) {
  uint64_t pos0 = 0;
  while (pos0 + 8 <= n) {
    uint64_t size = rd32(d + pos0);
    const uint8_t* t = d + pos0 + 4;
    uint64_t hdr = 8;
    if (size == 1) {
      if (pos0 + 16 > n) break;
      size = rd64(d + pos0 + 8);
      hdr = 16;
    } else if (size == 0) {
      size = n - pos0;
    }
    if (size < hdr || pos0 + size > n) break;
    if (!memcmp(t, "moof", 4)) {
      uint64_t moof_start = pos0, moof_s = pos0 + hdr, moof_e = pos0 + size;
      bool have_prev_traf = false;
      uint64_t traf_base_next = 0;
      for_boxes(d, moof_s, moof_e,
                [&](const uint8_t* t2, uint64_t traf_s, uint64_t traf_e) {
        if (memcmp(t2, "traf", 4)) return true;
        uint64_t s, e;
        if (!find_box(d, traf_s, traf_e, {"tfhd"}, 0, &s, &e)) return true;
        if (s + 8 > e) return true;
        uint32_t flags = rd32(d + s) & 0xFFFFFF;
        uint32_t this_tid = rd32(d + s + 4);
        uint64_t p = s + 8;
        bool have_base = false;
        uint64_t base = 0;
        if (flags & 0x01) {
          if (p + 8 > e) return true;
          base = rd64(d + p);
          have_base = true;
          p += 8;
        }
        if (flags & 0x02) p += 4;
        if (flags & 0x08) p += 4;
        uint64_t dsize = trex_size;
        if (flags & 0x10) {
          if (p + 4 > e) return true;
          dsize = rd32(d + p);
          p += 4;
        }
        if (!have_base)
          base = (flags & 0x20000) ? moof_start
                                   : (have_prev_traf ? traf_base_next
                                                     : moof_start);
        if (this_tid != tid) return true;
        bool have_run = false;
        uint64_t run_pos = 0;
        for_boxes(d, traf_s, traf_e,
                  [&](const uint8_t* t3, uint64_t s3, uint64_t e3) {
          if (memcmp(t3, "trun", 4) || s3 + 8 > e3) return true;
          uint32_t tf = rd32(d + s3) & 0xFFFFFF;
          uint32_t count = rd32(d + s3 + 4);
          uint64_t q = s3 + 8;
          if (tf & 0x01) {
            if (q + 4 > e3) return false;
            run_pos = base + (int64_t)(int32_t)rd32(d + q);
            have_run = true;
            q += 4;
          } else if (!have_run) {
            run_pos = base;
            have_run = true;
          }
          if (tf & 0x04) q += 4;
          uint64_t per = ((tf & 0x100) ? 4 : 0) + ((tf & 0x200) ? 4 : 0) +
                         ((tf & 0x400) ? 4 : 0) + ((tf & 0x800) ? 4 : 0);
          for (uint32_t i = 0; i < count; i++) {
            uint64_t size2 = dsize;
            uint64_t r = q + i * per;
            if (tf & 0x100) r += 4;
            if (tf & 0x200) {
              if (r + 4 > e3) return false;
              size2 = rd32(d + r);
            }
            if (!size2 || run_pos + size2 > n) return false;  // corrupt tail
            out->push_back({run_pos, size2});
            run_pos += size2;
          }
          return true;
        });
        if (have_run) {
          traf_base_next = run_pos;
          have_prev_traf = true;
        }
        return true;
      });
    }
    pos0 += size;
  }
}

static std::optional<H264Stream> demux_mp4(const uint8_t* d, size_t n) {
  uint64_t moov_s, moov_e;
  if (!find_box(d, 0, n, {"moov"}, 0, &moov_s, &moov_e)) return std::nullopt;
  std::optional<H264Stream> result;
  for_boxes(d, moov_s, moov_e, [&](const uint8_t* t, uint64_t ts, uint64_t te) {
    if (memcmp(t, "trak", 4) != 0) return true;
    // locate avcC inside stsd
    uint64_t stsd_s, stsd_e;
    if (!find_box(d, ts, te, {"mdia", "minf", "stbl", "stsd"}, 0, &stsd_s,
                  &stsd_e))
      return true;
    int length_size = 4;
    std::vector<Bytes> sps, pps;
    bool have_avcc = false;
    for_boxes(d, stsd_s + 8, stsd_e,
              [&](const uint8_t* st, uint64_t ss, uint64_t se) {
                if (memcmp(st, "avc1", 4) && memcmp(st, "avc3", 4)) return true;
                for_boxes(d, ss + 78, se,
                          [&](const uint8_t* bt, uint64_t bs, uint64_t be) {
                            if (memcmp(bt, "avcC", 4) == 0) {
                              parse_avcc_field(d + bs, be - bs, &length_size,
                                               &sps, &pps);
                              have_avcc = true;
                              return false;
                            }
                            return true;
                          });
                return !have_avcc;
              });
    if (!have_avcc) return true;

    uint64_t stbl_s, stbl_e;
    find_box(d, ts, te, {"mdia", "minf", "stbl"}, 0, &stbl_s, &stbl_e);
    uint64_t stsz_s = 0, stsz_e = 0, stco_s = 0, stco_e = 0, co64_s = 0,
             co64_e = 0, stsc_s = 0, stsc_e = 0;
    for_boxes(d, stbl_s, stbl_e, [&](const uint8_t* bt, uint64_t bs, uint64_t be) {
      if (!memcmp(bt, "stsz", 4)) stsz_s = bs, stsz_e = be;
      if (!memcmp(bt, "stco", 4)) stco_s = bs, stco_e = be;
      if (!memcmp(bt, "co64", 4)) co64_s = bs, co64_e = be;
      if (!memcmp(bt, "stsc", 4)) stsc_s = bs, stsc_e = be;
      return true;
    });
    if (!stsz_s || !stsc_s || (!stco_s && !co64_s)) return true;

    // sample sizes (bounds-checked: a lying count -> ParseError -> literal)
    if (stsz_s + 12 > stsz_e) throw ParseError("stsz underrun");
    uint32_t uniform = rd32(d + stsz_s + 4), n_samples = rd32(d + stsz_s + 8);
    if (!uniform && stsz_s + 12 + 4ull * n_samples > stsz_e)
      throw ParseError("stsz underrun");
    std::vector<uint64_t> sizes(n_samples);
    for (uint32_t i = 0; i < n_samples; i++)
      sizes[i] = uniform ? uniform : rd32(d + stsz_s + 12 + 4 * i);
    // chunk offsets
    std::vector<uint64_t> chunks;
    if (stco_s) {
      if (stco_s + 8 > stco_e) throw ParseError("stco underrun");
      uint32_t nc = rd32(d + stco_s + 4);
      if (stco_s + 8 + 4ull * nc > stco_e) throw ParseError("stco underrun");
      for (uint32_t i = 0; i < nc; i++) chunks.push_back(rd32(d + stco_s + 8 + 4 * i));
    } else {
      if (co64_s + 8 > co64_e) throw ParseError("co64 underrun");
      uint32_t nc = rd32(d + co64_s + 4);
      if (co64_s + 8 + 8ull * nc > co64_e) throw ParseError("co64 underrun");
      for (uint32_t i = 0; i < nc; i++) chunks.push_back(rd64(d + co64_s + 8 + 8 * i));
    }
    // stsc entries
    struct Ent {
      uint32_t first_chunk, spc;
    };
    std::vector<Ent> stsc;
    if (stsc_s + 8 > stsc_e) throw ParseError("stsc underrun");
    uint32_t ne = rd32(d + stsc_s + 4);
    if (stsc_s + 8 + 12ull * ne > stsc_e) throw ParseError("stsc underrun");
    for (uint32_t i = 0; i < ne; i++)
      stsc.push_back({rd32(d + stsc_s + 8 + 12 * i), rd32(d + stsc_s + 12 + 12 * i)});

    H264Stream stream;
    stream.sps_list = sps;
    stream.pps_list = pps;
    std::vector<std::pair<uint64_t, uint64_t>> samples;
    size_t si = 0;
    for (size_t ci = 0; ci < chunks.size(); ci++) {
      uint32_t spc = 1;
      for (auto& e : stsc) {
        if (ci + 1 >= e.first_chunk)
          spc = e.spc;
        else
          break;
      }
      uint64_t pos = chunks[ci];
      for (uint32_t k = 0; k < spc && si < sizes.size(); k++) {
        if (pos + sizes[si] > n) throw ParseError("sample beyond file");
        samples.push_back({pos, sizes[si]});
        pos += sizes[si];
        si++;
      }
    }
    // fragmented MP4: samples described by moof/traf/trun after the
    // (possibly empty) moov
    uint32_t tid = track_id_of(d, ts, te);
    if (tid)
      fragment_samples(d, n, tid, trex_size_of(d, moov_s, moov_e, tid),
                       &samples);
    for (auto& [off, size] : samples) {
      uint64_t end = off + size;
      uint64_t p = off;
      while (p + length_size <= end) {
        uint64_t ln = 0;
        if (length_size == 4)
          ln = rd32(d + p);
        else if (length_size == 2)
          ln = rd16(d + p);
        else
          ln = d[p];
        p += length_size;
        if (ln == 0 || p + ln > end) break;
        uint8_t hdr = d[p];
        stream.nals.push_back(
            {p, ln, hdr & 0x1F, (hdr >> 5) & 3});
        p += ln;
      }
    }
    result = std::move(stream);
    return false;  // first AVC track wins
  });
  return result;
}

// ------------------------------------------------------------- matroska --
// Mirror of utils/mkv.py: EBML walk -> AVC track (CodecPrivate avcC) ->
// (Simple)Block frames -> length-prefixed NALs (contiguous in the file).
namespace mkv {

struct Vint {
  int64_t v;
  uint64_t next;
  bool ok;
};

static Vint vint(const uint8_t* d, uint64_t pos, uint64_t end, bool keep) {
  if (pos >= end) return {0, 0, false};
  uint8_t b0 = d[pos];
  if (b0 == 0) return {0, 0, false};
  int length = 1;
  uint8_t mask = 0x80;
  while (!(b0 & mask)) {
    length++;
    mask >>= 1;
  }
  if (pos + length > end) return {0, 0, false};
  uint64_t v = keep ? b0 : (uint8_t)(b0 & (mask - 1));
  bool unknown = (b0 & (mask - 1)) == (uint8_t)(mask - 1);
  for (int i = 1; i < length; i++) {
    v = (v << 8) | d[pos + i];
    unknown = unknown && d[pos + i] == 0xFF;
  }
  int64_t out = (int64_t)v;
  if (!keep && unknown) out = -1;  // unknown size
  return {out, pos + (uint64_t)length, true};
}

// iterate elements of [start, end); f(id, body_s, body_e) -> keep going?
template <typename F>
static void elements(const uint8_t* d, uint64_t start, uint64_t end, F f) {
  uint64_t pos = start;
  while (pos < end) {
    Vint id = vint(d, pos, end, true);
    if (!id.ok) return;
    Vint sz = vint(d, id.next, end, false);
    if (!sz.ok) return;
    uint64_t body = sz.next;
    if (sz.v < 0) {  // unknown size: extends to parent end
      f((uint64_t)id.v, body, end);
      return;
    }
    if (body + (uint64_t)sz.v > end) return;
    if (!f((uint64_t)id.v, body, body + (uint64_t)sz.v)) return;
    pos = body + (uint64_t)sz.v;
  }
}

enum : uint64_t {
  SEGMENT = 0x18538067,
  TRACKS = 0x1654AE6B,
  TRACK_ENTRY = 0xAE,
  TRACK_NUMBER = 0xD7,
  CODEC_ID = 0x86,
  CODEC_PRIVATE = 0x63A2,
  CLUSTER = 0x1F43B675,
  SIMPLE_BLOCK = 0xA3,
  BLOCK_GROUP = 0xA0,
  BLOCK = 0xA1,
};

static uint64_t uint_at(const uint8_t* d, uint64_t s, uint64_t e) {
  uint64_t v = 0;
  for (uint64_t i = s; i < e; i++) v = (v << 8) | d[i];
  return v;
}

}  // namespace mkv

static std::optional<H264Stream> demux_mkv(const uint8_t* d, size_t n) {
  using namespace mkv;
  uint64_t seg_s = 0, seg_e = 0;
  elements(d, 0, n, [&](uint64_t id, uint64_t s, uint64_t e) {
    if (id == SEGMENT && !seg_e) {
      seg_s = s;
      seg_e = e;
      return false;
    }
    return true;
  });
  if (!seg_e) return std::nullopt;
  int64_t want = -1;
  int length_size = 4;
  std::vector<Bytes> sps, pps;
  elements(d, seg_s, seg_e, [&](uint64_t id, uint64_t s, uint64_t e) {
    if (id != TRACKS) return true;
    elements(d, s, e, [&](uint64_t tid, uint64_t ts, uint64_t te) {
      if (tid != TRACK_ENTRY) return true;
      int64_t num = -1;
      bool avc = false;
      const uint8_t* priv = nullptr;
      uint64_t priv_len = 0;
      elements(d, ts, te, [&](uint64_t fid, uint64_t fs, uint64_t fe) {
        if (fid == TRACK_NUMBER) num = (int64_t)uint_at(d, fs, fe);
        if (fid == CODEC_ID)
          avc = fe - fs >= 15 && memcmp(d + fs, "V_MPEG4/ISO/AVC", 15) == 0;
        if (fid == CODEC_PRIVATE) {
          priv = d + fs;
          priv_len = fe - fs;
        }
        return true;
      });
      if (avc && num >= 0 && priv) {
        parse_avcc_field(priv, priv_len, &length_size, &sps, &pps);
        want = num;
        return false;
      }
      return true;
    });
    return want < 0;
  });
  if (want < 0) return std::nullopt;
  H264Stream stream;
  stream.sps_list = sps;
  stream.pps_list = pps;
  auto scan_frame = [&](uint64_t fs, uint64_t fe) {
    uint64_t pos = fs;
    while (pos + (uint64_t)length_size <= fe) {
      uint64_t ln = uint_at(d, pos, pos + length_size);
      pos += length_size;
      if (ln == 0 || pos + ln > fe) break;
      uint8_t hdr = d[pos];
      stream.nals.push_back({pos, ln, hdr & 0x1F, (hdr >> 5) & 3});
      pos += ln;
    }
  };
  auto scan_block = [&](uint64_t s, uint64_t e) {
    Vint track = vint(d, s, e, false);
    if (!track.ok || track.v != want) return;
    uint64_t p = track.next;
    if (p + 3 > e) return;
    uint8_t flags = d[p + 2];
    p += 3;
    int lacing = (flags >> 1) & 3;
    if (lacing == 0) {
      scan_frame(p, e);
      return;
    }
    if (p >= e) return;
    int n_frames = d[p] + 1;
    p += 1;
    std::vector<int64_t> sizes;
    if (lacing == 2) {  // fixed
      uint64_t total = e - p;
      if (total % n_frames) return;
      sizes.assign(n_frames - 1, (int64_t)(total / n_frames));
    } else if (lacing == 1) {  // Xiph
      for (int i = 0; i < n_frames - 1; i++) {
        int64_t v = 0;
        while (p < e) {
          v += d[p];
          if (d[p] != 255) {
            p++;
            break;
          }
          p++;
        }
        sizes.push_back(v);
      }
    } else {  // EBML: first absolute, rest signed deltas
      Vint first = vint(d, p, e, false);
      if (!first.ok) return;
      sizes.push_back(first.v);
      p = first.next;
      for (int i = 0; i < n_frames - 2; i++) {
        if (p >= e) return;
        uint8_t b0 = d[p];
        int length = 1;
        uint8_t mask = 0x80;
        while (!(b0 & mask)) {
          length++;
          mask >>= 1;
        }
        Vint v = vint(d, p, e, false);
        if (!v.ok) return;
        int64_t bias = ((int64_t)1 << (7 * length - 1)) - 1;
        sizes.push_back(sizes.back() + v.v - bias);
        p = v.next;
      }
    }
    for (int64_t sz : sizes) {
      if (sz < 0 || p + (uint64_t)sz > e) return;
      scan_frame(p, p + sz);
      p += sz;
    }
    scan_frame(p, e);  // last frame: remainder
  };
  elements(d, seg_s, seg_e, [&](uint64_t id, uint64_t cs, uint64_t ce) {
    if (id != CLUSTER) return true;
    elements(d, cs, ce, [&](uint64_t bid, uint64_t bs, uint64_t be) {
      if (bid == SIMPLE_BLOCK) {
        scan_block(bs, be);
      } else if (bid == BLOCK_GROUP) {
        elements(d, bs, be, [&](uint64_t gid, uint64_t gs, uint64_t ge) {
          if (gid == BLOCK) scan_block(gs, ge);
          return true;
        });
      }
      return true;
    });
    return true;
  });
  return stream;
}

static std::optional<H264Stream> demux_annexb(const uint8_t* d, size_t n) {
  std::vector<uint64_t> starts;
  for (size_t i = 0; i + 3 <= n;) {
    if (d[i] == 0 && d[i + 1] == 0) {
      if (d[i + 2] == 1) {
        starts.push_back(i + 3);
        i += 3;
        continue;
      }
      if (i + 4 <= n && d[i + 2] == 0 && d[i + 3] == 1) {
        starts.push_back(i + 4);
        i += 4;
        continue;
      }
    }
    i++;
  }
  if (starts.empty()) return std::nullopt;
  H264Stream stream;
  for (size_t k = 0; k < starts.size(); k++) {
    uint64_t s = starts[k];
    uint64_t e;
    if (k + 1 == starts.size()) {
      e = n;
    } else {
      e = starts[k + 1] - 3;
      if (e >= s + 1 && d[e - 1] == 0) e -= 1;  // 4-byte prefix
    }
    if (e <= s) continue;
    uint8_t hdr = d[s];
    NalSpan span{s, e - s, hdr & 0x1F, (hdr >> 5) & 3};
    stream.nals.push_back(span);
    if (span.nal_type == 7) stream.sps_list.emplace_back(d + s, d + e);
    if (span.nal_type == 8) stream.pps_list.emplace_back(d + s, d + e);
  }
  return stream;
}

// -------------------------------------------------------------- mpeg-ts --
// Mirror of utils/ts.py: PAT -> PMT -> H.264 PID, PES payload segments, then
// an Annex-B scan over the virtual ES stream; NALs split across packets
// carry their (offset, length) segment lists.
// Shared TS/PS ES-tail: (file_off, len) video-ES segments -> H264Stream
// (merge adjacent segments, Annex-B scan over the virtual stream, map
// each NAL back to file segments; split NALs carry `segs`).
static std::optional<H264Stream> es_to_stream(
    const uint8_t* d,
    std::vector<std::pair<uint64_t, uint64_t>> es) {
  if (es.empty()) return std::nullopt;
  // merge file-adjacent segments
  std::vector<std::pair<uint64_t, uint64_t>> merged{es[0]};
  for (size_t i = 1; i < es.size(); i++) {
    if (merged.back().first + merged.back().second == es[i].first)
      merged.back().second += es[i].second;
    else
      merged.push_back(es[i]);
  }
  es = std::move(merged);
  Bytes buf;
  std::vector<uint64_t> cum{0};
  for (auto& [o, l] : es) {
    buf.insert(buf.end(), d + o, d + o + l);
    cum.push_back(cum.back() + l);
  }
  auto v2segs = [&](uint64_t vs, uint64_t ve) {
    std::vector<std::pair<uint64_t, uint64_t>> segs;
    size_t i = (size_t)(std::upper_bound(cum.begin(), cum.end(), vs) -
                        cum.begin()) - 1;
    while (vs < ve) {
      uint64_t take = std::min(ve - vs, cum[i + 1] - vs);
      segs.push_back({es[i].first + (vs - cum[i]), take});
      vs += take;
      i++;
    }
    return segs;
  };
  // Annex-B scan over the virtual stream
  std::vector<uint64_t> starts;
  uint64_t vn = buf.size();
  for (uint64_t i = 0; i + 3 <= vn;) {
    if (buf[i] == 0 && buf[i + 1] == 0) {
      if (buf[i + 2] == 1) {
        starts.push_back(i + 3);
        i += 3;
        continue;
      }
      if (i + 4 <= vn && buf[i + 2] == 0 && buf[i + 3] == 1) {
        starts.push_back(i + 4);
        i += 4;
        continue;
      }
    }
    i++;
  }
  if (starts.empty()) return std::nullopt;
  H264Stream stream;
  for (size_t k = 0; k < starts.size(); k++) {
    uint64_t s = starts[k];
    uint64_t e;
    if (k + 1 == starts.size()) {
      e = vn;
    } else {
      e = starts[k + 1] - 3;
      if (e >= s + 1 && buf[e - 1] == 0) e--;
    }
    // strip ES zero stuffing (a conformant NAL never ends in 0x00)
    while (e > s + 1 && buf[e - 1] == 0) e--;
    if (e <= s) continue;
    uint8_t hdr = buf[s];
    auto segs = v2segs(s, e);
    NalSpan span{segs[0].first, e - s, hdr & 0x1F, (hdr >> 5) & 3, {}};
    if (segs.size() > 1) span.segs = std::move(segs);
    stream.nals.push_back(std::move(span));
    if ((hdr & 0x1F) == 7) stream.sps_list.emplace_back(buf.begin() + s, buf.begin() + e);
    if ((hdr & 0x1F) == 8) stream.pps_list.emplace_back(buf.begin() + s, buf.begin() + e);
  }
  return stream;
}


static std::optional<H264Stream> demux_ts(const uint8_t* d, size_t n) {
  constexpr size_t PKT = 188;
  if (n < PKT || d[0] != 0x47) return std::nullopt;
  for (size_t k = 1; k < std::min<size_t>(8, n / PKT); k++)
    if (d[k * PKT] != 0x47) return std::nullopt;

  std::vector<int> pmt_pids;
  int video_pid = -1;
  std::vector<std::pair<uint64_t, uint64_t>> es;  // video ES segments
  for (size_t p = 0; p + PKT <= n; p += PKT) {
    if (d[p] != 0x47) break;
    int pid = ((d[p + 1] & 0x1F) << 8) | d[p + 2];
    bool pusi = d[p + 1] & 0x40;
    int afc = (d[p + 3] >> 4) & 3;
    size_t pos = p + 4;
    if (afc & 2) {
      if (pos >= p + PKT) continue;
      pos += 1 + d[pos];
    }
    if (!(afc & 1) || pos >= p + PKT) continue;
    size_t lim = p + PKT;
    if (pid == 0 && pusi) {  // PAT
      size_t t = pos + 1 + d[pos];
      if (t + 12 > lim || d[t] != 0) continue;
      size_t sect_len = ((d[t + 1] & 0xF) << 8) | d[t + 2];
      size_t ent = t + 8, end = t + 3 + sect_len - 4;
      while (ent + 4 <= end && ent + 4 <= lim) {
        int prog = (d[ent] << 8) | d[ent + 1];
        int mpid = ((d[ent + 2] & 0x1F) << 8) | d[ent + 3];
        if (prog != 0) pmt_pids.push_back(mpid);
        ent += 4;
      }
    } else if (pusi && video_pid < 0 &&
               std::find(pmt_pids.begin(), pmt_pids.end(), pid) !=
                   pmt_pids.end()) {  // PMT
      size_t t = pos + 1 + d[pos];
      if (t + 12 > lim || d[t] != 2) continue;
      size_t sect_len = ((d[t + 1] & 0xF) << 8) | d[t + 2];
      size_t pinfo = ((d[t + 10] & 0xF) << 8) | d[t + 11];
      size_t ent = t + 12 + pinfo, end = t + 3 + sect_len - 4;
      while (ent + 5 <= end && ent + 5 <= lim) {
        int stype = d[ent];
        int epid = ((d[ent + 1] & 0x1F) << 8) | d[ent + 2];
        size_t eslen = ((d[ent + 3] & 0xF) << 8) | d[ent + 4];
        if (stype == 0x1B && video_pid < 0) video_pid = epid;
        ent += 5 + eslen;
      }
    } else if (video_pid >= 0 && pid == video_pid) {
      if (pusi) {
        if (pos + 9 <= lim && d[pos] == 0 && d[pos + 1] == 0 &&
            d[pos + 2] == 1)
          pos = pos + 9 + d[pos + 8];
      }
      if (pos < lim) es.push_back({pos, lim - pos});
    }
  }
  return es_to_stream(d, std::move(es));
}



// ------------------------------------------------------------------- ps --
// Mirror of utils/ps.py: MPEG program stream — video PES packets (stream
// ids 0xE0-0xEF) between pack headers carry Annex-B; NALs can span PES
// packets and ride the shared TS/PS virtual-ES machinery.
static std::optional<H264Stream> demux_ps(const uint8_t* d, size_t n) {
  if (n < 16 || d[0] != 0 || d[1] != 0 || d[2] != 1 || d[3] != 0xBA)
    return std::nullopt;
  std::vector<std::pair<uint64_t, uint64_t>> es;
  size_t pos = 0;
  while (pos + 4 <= n) {
    if (!(d[pos] == 0 && d[pos + 1] == 0 && d[pos + 2] == 1)) {
      pos++;  // resync (stuffing/garbage between packs)
      continue;
    }
    uint8_t sid = d[pos + 3];
    if (sid == 0xBA) {  // pack header
      if (pos + 14 > n) break;
      if ((d[pos + 4] >> 6) == 1) {  // MPEG-2: '01' marker
        pos += 14 + (d[pos + 13] & 7);
      } else {  // MPEG-1 pack: fixed 12 bytes
        pos += 12;
      }
      continue;
    }
    if (sid == 0xB9) break;  // program end
    if (pos + 6 > n) break;
    size_t plen = ((size_t)d[pos + 4] << 8) | d[pos + 5];
    size_t body = pos + 6;
    size_t end = std::min(body + plen, n);
    if (sid >= 0xE0 && sid <= 0xEF && body + 3 <= end) {
      size_t payload;
      if ((d[body] >> 6) == 2) {  // MPEG-2 PES header
        payload = body + 3 + d[body + 2];
      } else {  // MPEG-1: FF* stuffing, optional STD, PTS/DTS
        size_t q = body;
        while (q < end && d[q] == 0xFF) q++;
        if (q < end && (d[q] >> 6) == 1) q += 2;  // STD buffer
        if (q < end && (d[q] >> 4) == 2)
          q += 5;
        else if (q < end && (d[q] >> 4) == 3)
          q += 10;
        else
          q += 1;  // '0000 1111' no-timestamp marker
        payload = q;
      }
      if (payload < end) es.push_back({payload, end - payload});
    }
    pos = plen ? end : pos + 6;
  }
  if (es.empty()) return std::nullopt;
  return es_to_stream(d, std::move(es));
}

// ------------------------------------------------------------------ avi --
// Mirror of utils/avi.py: classic AVI wraps H.264 as Annex-B inside the
// movi LIST's per-frame 'NNdc'/'NNdb' chunks (SPS/PPS in-band).
static void scan_annexb_range(const uint8_t* d, uint64_t s, uint64_t e,
                              H264Stream* stream) {
  std::vector<uint64_t> starts;
  for (uint64_t i = s; i + 3 <= e;) {
    if (d[i] == 0 && d[i + 1] == 0) {
      if (d[i + 2] == 1) {
        starts.push_back(i + 3);
        i += 3;
        continue;
      }
      if (i + 4 <= e && d[i + 2] == 0 && d[i + 3] == 1) {
        starts.push_back(i + 4);
        i += 4;
        continue;
      }
    }
    i++;
  }
  for (size_t k = 0; k < starts.size(); k++) {
    uint64_t ns = starts[k];
    uint64_t ne;
    if (k + 1 == starts.size()) {
      ne = e;
    } else {
      ne = starts[k + 1] - 3;
      if (ne >= ns + 1 && d[ne - 1] == 0) ne -= 1;  // 4-byte prefix
    }
    if (ne <= ns) continue;
    uint8_t hdr = d[ns];
    NalSpan span{ns, ne - ns, hdr & 0x1F, (hdr >> 5) & 3};
    stream->nals.push_back(span);
    if (span.nal_type == 7) stream->sps_list.emplace_back(d + ns, d + ne);
    if (span.nal_type == 8) stream->pps_list.emplace_back(d + ns, d + ne);
  }
}

static uint32_t rd32le(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

template <class F>
static void riff_chunks(const uint8_t* d, uint64_t pos, uint64_t end, F f) {
  while (pos + 8 <= end) {
    const uint8_t* ckid = d + pos;
    uint64_t size = rd32le(d + pos + 4);
    uint64_t body = pos + 8;
    if (body + size > end) break;
    f(ckid, body, body + size);
    pos = body + size + (size & 1);  // chunks pad to even
  }
}

static void avi_movi(const uint8_t* d, uint64_t s, uint64_t e,
                     const char* tag_dc, const char* tag_db,
                     H264Stream* stream) {
  // Iterative worklist: nested LIST chunks ('rec ' groupings) are walked
  // without recursion so a crafted AVI with thousands of nesting levels
  // cannot overflow the stack (it falls back to literal like any other
  // malformed input).
  std::vector<std::pair<uint64_t, uint64_t>> work{{s, e}};
  while (!work.empty()) {
    auto [ws, we] = work.back();
    work.pop_back();
    riff_chunks(d, ws, we, [&](const uint8_t* ckid, uint64_t cs, uint64_t ce) {
      if (!memcmp(ckid, "LIST", 4)) {  // 'rec ' grouping
        if (ce > cs + 4) work.emplace_back(cs + 4, ce);
      } else if (!memcmp(ckid, tag_dc, 4) || !memcmp(ckid, tag_db, 4)) {
        scan_annexb_range(d, cs, ce, stream);
      }
    });
  }
}

static std::optional<H264Stream> demux_avi(const uint8_t* d, size_t n) {
  if (n < 16 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "AVI ", 4))
    return std::nullopt;
  int video_idx = -1;
  std::vector<std::pair<uint64_t, uint64_t>> movi;
  riff_chunks(d, 12, n, [&](const uint8_t* ckid, uint64_t s, uint64_t e) {
    if (memcmp(ckid, "LIST", 4) || e - s < 4) return;
    if (!memcmp(d + s, "hdrl", 4)) {
      int idx = 0;
      riff_chunks(d, s + 4, e, [&](const uint8_t* c2, uint64_t s2,
                                   uint64_t e2) {
        if (!memcmp(c2, "LIST", 4) && e2 - s2 >= 4 &&
            !memcmp(d + s2, "strl", 4)) {
          riff_chunks(d, s2 + 4, e2, [&](const uint8_t* c3, uint64_t s3,
                                         uint64_t e3) {
            if (!memcmp(c3, "strh", 4) && e3 - s3 >= 4 &&
                !memcmp(d + s3, "vids", 4) && video_idx < 0)
              video_idx = idx;
          });
          idx++;
        }
      });
    } else if (!memcmp(d + s, "movi", 4)) {
      movi.emplace_back(s + 4, e);
    }
  });
  if (video_idx < 0 || movi.empty()) return std::nullopt;
  char tag_dc[5], tag_db[5];
  snprintf(tag_dc, sizeof tag_dc, "%02ddc", video_idx);
  snprintf(tag_db, sizeof tag_db, "%02ddb", video_idx);
  H264Stream stream;
  for (auto& me : movi) avi_movi(d, me.first, me.second, tag_dc, tag_db,
                                 &stream);
  if (stream.nals.empty()) return std::nullopt;
  return stream;
}

// ------------------------------------------------------------------ flv --
// Mirror of utils/flv.py: video tags (type 9, codec 7) — the sequence
// header carries the avcC, NALU packets carry length-prefixed units.
static std::optional<H264Stream> demux_flv(const uint8_t* d, size_t n) {
  if (n < 13 || memcmp(d, "FLV", 3)) return std::nullopt;
  uint64_t pos = ((uint64_t)d[5] << 24) | ((uint64_t)d[6] << 16) |
                 ((uint64_t)d[7] << 8) | d[8];
  pos += 4;  // PreviousTagSize0
  H264Stream stream;
  int length_size = 4;
  bool have_avcc = false;
  while (pos + 11 <= n) {
    int ttype = d[pos] & 0x1F;
    uint64_t dsize = ((uint64_t)d[pos + 1] << 16) |
                     ((uint64_t)d[pos + 2] << 8) | d[pos + 3];
    uint64_t body = pos + 11;
    uint64_t end = body + dsize;
    if (end > n) break;
    if (ttype == 9 && dsize >= 5 && (d[body] & 0x0F) == 7) {
      int pkt = d[body + 1];
      uint64_t p = body + 5;  // frame/codec, AVCPacketType, CompositionTime
      if (pkt == 0) {  // AVC sequence header: avcC record
        try {
          parse_avcc_field(d + p, end - p, &length_size, &stream.sps_list,
                           &stream.pps_list);
          have_avcc = true;
        } catch (const ParseError&) {
          return std::nullopt;
        }
      } else if (pkt == 1) {  // NALU packet: length-prefixed units
        while (p + (uint64_t)length_size <= end) {
          uint64_t ln = 0;
          for (int k = 0; k < length_size; k++) ln = (ln << 8) | d[p + k];
          p += length_size;
          if (ln == 0 || p + ln > end) break;
          uint8_t hdr = d[p];
          NalSpan span{p, ln, hdr & 0x1F, (hdr >> 5) & 3};
          stream.nals.push_back(span);
          p += ln;
        }
      }
    }
    pos = end + 4;  // PreviousTagSize
  }
  if (stream.nals.empty() || !have_avcc) return std::nullopt;
  return stream;
}

std::optional<H264Stream> demux(const uint8_t* data, size_t size) {
  if (size > 12) {
    const char* k = (const char*)data + 4;
    if (!memcmp(k, "ftyp", 4) || !memcmp(k, "moov", 4) || !memcmp(k, "mdat", 4) ||
        !memcmp(k, "wide", 4) || !memcmp(k, "free", 4)) {
      // malformed MP4 propagates (compress falls back to a pure-literal
      // container), matching the Python path's behavior exactly
      auto s = demux_mp4(data, size);
      if (s) return s;
    }
  }
  if (size > 8 && data[0] == 0x1A && data[1] == 0x45 && data[2] == 0xDF &&
      data[3] == 0xA3) {
    auto s = demux_mkv(data, size);
    if (s) return s;
  }
  if (size >= 188 * 4 && data[0] == 0x47) {
    auto s = demux_ts(data, size);
    if (s) return s;
  }
  if (size > 12 && !memcmp(data, "RIFF", 4) && !memcmp(data + 8, "AVI ", 4)) {
    auto s = demux_avi(data, size);
    if (s) return s;
  }
  if (size > 13 && !memcmp(data, "FLV", 3)) {
    auto s = demux_flv(data, size);
    if (s) return s;
  }
  if (size > 16 && data[0] == 0 && data[1] == 0 && data[2] == 1 &&
      data[3] == 0xBA) {  // MPEG-PS pack header
    auto s = demux_ps(data, size);
    if (s) return s;
  }
  return demux_annexb(data, size);
}

}  // namespace avtpu
