"""AVI (RIFF) demuxer — owned replacement for the libavformat surface the
reference gets free (recode.cpp:89-96): classic AVI wraps H.264 as Annex-B
byte streams inside per-frame 'NNdc'/'NNdb' chunks of the movi LIST (AVI
has no global-header channel, so SPS/PPS ride in-band).

Like the other demuxers, NAL spans reference absolute offsets in the
original file; all container bytes outside the spans become literal
blocks, so recompression stays byte-exact without any AVI-specific state.
"""

import struct


def _chunks(data, pos, end):
    """Iterate RIFF chunks: yields (ckid, body_start, body_end)."""
    while pos + 8 <= end:
        ckid = bytes(data[pos:pos + 4])
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = pos + 8
        if body + size > end:
            break
        yield ckid, body, body + size
        pos = body + size + (size & 1)  # chunks pad to even


def _scan_annexb(data, s, e, vout):
    """Append Annex-B NAL spans found in data[s:e) to vout (starts, ends)."""
    i = s
    starts = []
    while i + 3 <= e:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if i + 4 <= e and data[i + 2] == 0 and data[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    for k, ns in enumerate(starts):
        if k + 1 == len(starts):
            ne = e
        else:
            ne = starts[k + 1] - 3
            if ne - 1 >= ns and data[ne - 1] == 0:
                ne -= 1  # 4-byte prefix
        if ne > ns:
            vout.append((ns, ne))


def demux_avi(data, NalSpan):
    """-> (sps_list, pps_list, nals) or None if not an AVI with video."""
    if len(data) < 16 or bytes(data[:4]) != b"RIFF" or \
            bytes(data[8:12]) != b"AVI ":
        return None
    # stream order in the hdrl LIST defines the chunk-id stream numbers
    video_idx = None
    movi = []
    for ckid, s, e in _chunks(data, 12, len(data)):
        if ckid != b"LIST":
            continue
        ltype = bytes(data[s:s + 4])
        if ltype == b"hdrl":
            idx = 0
            for c2, s2, e2 in _chunks(data, s + 4, e):
                if c2 == b"LIST" and bytes(data[s2:s2 + 4]) == b"strl":
                    for c3, s3, e3 in _chunks(data, s2 + 4, e2):
                        if c3 == b"strh" and e3 - s3 >= 4:
                            if bytes(data[s3:s3 + 4]) == b"vids" and \
                                    video_idx is None:
                                video_idx = idx
                    idx += 1
        elif ltype == b"movi":
            movi.append((s + 4, e))
    if video_idx is None or not movi:
        return None
    tag_dc = b"%02ddc" % video_idx
    tag_db = b"%02ddb" % video_idx
    spans = []

    def walk_movi(s, e):
        # In file order, without recursion (a crafted AVI with thousands of
        # nesting levels cannot raise RecursionError out of demux): a nested
        # LIST ('rec ' grouping) is entered where it stands, and the list
        # around it resumes after it from the stack.
        work = [(s, e)]
        while work:
            ws, we = work.pop()
            for ckid, cs, ce in _chunks(data, ws, we):
                if ckid == b"LIST":  # 'rec ' grouping
                    if ce > cs + 4:
                        work.append((ce + ((ce - cs) & 1), we))
                        work.append((cs + 4, ce))
                        break
                elif ckid in (tag_dc, tag_db):
                    _scan_annexb(data, cs, ce, spans)

    for s, e in movi:
        walk_movi(s, e)
    if not spans:
        return None
    sps, pps, nals = [], [], []
    for ns, ne in spans:
        hdr = data[ns]
        span = NalSpan(ns, ne - ns, nal_type=hdr & 0x1F,
                       nal_ref_idc=(hdr >> 5) & 3)
        nals.append(span)
        if span.nal_type == 7:
            sps.append(bytes(data[ns:ne]))
        elif span.nal_type == 8:
            pps.append(bytes(data[ns:ne]))
    return sps, pps, nals
