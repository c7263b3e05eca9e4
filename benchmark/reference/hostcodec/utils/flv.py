"""FLV demuxer — owned replacement for the libavformat surface the
reference gets free (recode.cpp:89-96): FLV carries H.264 in video tags
(type 9, codec id 7).  The AVC sequence-header packet holds the avcC
(SPS/PPS + NAL length size); NALU packets hold length-prefixed NAL units,
exactly like MP4 samples.

NAL spans reference absolute offsets in the original file; all container
bytes outside the spans become literal blocks, so recompression stays
byte-exact with no FLV-specific state.
"""

import struct


def demux_flv(data, NalSpan, parse_avcc):
    """-> (sps_list, pps_list, nals) or None if not FLV with AVC video.

    parse_avcc(blob) -> (length_size, sps_list, pps_list) is injected
    (utils.mp4._parse_avcc) to keep the avcC parser single-sourced."""
    if len(data) < 13 or bytes(data[:3]) != b"FLV":
        return None
    off = struct.unpack(">I", data[5:9])[0]
    pos = off + 4  # skip PreviousTagSize0
    sps, pps, nals = [], [], []
    length_size = 4
    have_avcc = False
    while pos + 11 <= len(data):
        ttype = data[pos] & 0x1F
        dsize = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = pos + 11
        end = body + dsize
        if end > len(data):
            break
        if ttype == 9 and dsize >= 5 and (data[body] & 0x0F) == 7:
            pkt = data[body + 1]
            p = body + 5  # frame/codec byte, AVCPacketType, CompositionTime
            if pkt == 0:  # AVC sequence header: avcC record
                # A malformed avcC must mean "not demuxable" (literal
                # fallback), not an exception out of demux — mirrors the
                # C++ demux_flv's ParseError -> nullopt behavior.
                try:
                    length_size, s_l, p_l = parse_avcc(data[p:end])
                except (struct.error, AssertionError, IndexError,
                        ValueError):
                    return None
                sps += s_l
                pps += p_l
                have_avcc = True
            elif pkt == 1:  # NALU packet: length-prefixed units
                while p + length_size <= end:
                    ln = int.from_bytes(data[p:p + length_size], "big")
                    p += length_size
                    if ln == 0 or p + ln > end:
                        break
                    hdr = data[p]
                    nals.append(NalSpan(p, ln, nal_type=hdr & 0x1F,
                                        nal_ref_idc=(hdr >> 5) & 3))
                    p += ln
        pos = end + 4  # skip PreviousTagSize
    if not nals or not have_avcc:
        return None
    return sps, pps, nals
