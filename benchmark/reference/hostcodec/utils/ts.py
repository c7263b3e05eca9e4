"""MPEG-TS demux: locate H.264 NAL units in a transport stream.

Unlike MP4/MKV, a TS slice NAL is split across 188-byte packets (4-byte
headers, adaptation fields, interleaved PIDs), so NALs are NOT contiguous in
the file.  The demuxer returns NalSpans carrying a `segs` list of
(file_offset, length) pieces; the recoded container stores the in-NAL gap
bytes per slice block so decompression can re-scatter the rebuilt NAL into
the exact original layout (the TS analog of the reference's byte-exact
passthrough via libavformat, recode.cpp:89-96).
"""

import bisect

PKT = 188


def _psi_start(data, pos):
    """Skip the pointer_field of a PSI payload."""
    return pos + 1 + data[pos]


def demux_ts(data, nal_span):
    n = len(data)
    if n < PKT or data[0] != 0x47:
        return None
    for k in range(1, min(8, n // PKT)):
        if data[k * PKT] != 0x47:
            return None

    pmt_pids = set()
    video_pid = None
    es = []  # (file_off, len) video-ES segments in stream order
    for p in range(0, n - PKT + 1, PKT):
        if data[p] != 0x47:
            break
        pid = ((data[p + 1] & 0x1F) << 8) | data[p + 2]
        pusi = data[p + 1] & 0x40
        afc = (data[p + 3] >> 4) & 3
        pos = p + 4
        if afc & 2:  # adaptation field
            if pos >= p + PKT:
                continue
            pos += 1 + data[pos]
        if not (afc & 1) or pos >= p + PKT:
            continue
        try:
            if pid == 0 and pusi:  # PAT
                t = _psi_start(data, pos)
                if data[t] != 0:
                    continue
                sect_len = ((data[t + 1] & 0xF) << 8) | data[t + 2]
                ent, end = t + 8, t + 3 + sect_len - 4
                while ent + 4 <= end:
                    prog = (data[ent] << 8) | data[ent + 1]
                    mpid = ((data[ent + 2] & 0x1F) << 8) | data[ent + 3]
                    if prog != 0:
                        pmt_pids.add(mpid)
                    ent += 4
            elif pid in pmt_pids and pusi and video_pid is None:  # PMT
                t = _psi_start(data, pos)
                if data[t] != 2:
                    continue
                sect_len = ((data[t + 1] & 0xF) << 8) | data[t + 2]
                pinfo = ((data[t + 10] & 0xF) << 8) | data[t + 11]
                ent, end = t + 12 + pinfo, t + 3 + sect_len - 4
                while ent + 5 <= end:
                    stype = data[ent]
                    epid = ((data[ent + 1] & 0x1F) << 8) | data[ent + 2]
                    eslen = ((data[ent + 3] & 0xF) << 8) | data[ent + 4]
                    if stype == 0x1B and video_pid is None:
                        video_pid = epid
                    ent += 5 + eslen
            elif video_pid is not None and pid == video_pid:
                if pusi:
                    # PES header: 000001 sid len(2) flags(2) hdr_len(1)
                    if (
                        pos + 9 <= p + PKT
                        and data[pos] == 0
                        and data[pos + 1] == 0
                        and data[pos + 2] == 1
                    ):
                        pos = pos + 9 + data[pos + 8]
                if pos < p + PKT:
                    es.append((pos, p + PKT - pos))
        except IndexError:
            continue
    if not es or video_pid is None:
        return None
    return es_to_nals(data, es, nal_span)


def es_to_nals(data, es, nal_span):
    """Shared ES-tail: (file_off, len) video-ES segments -> NAL spans.

    Merges file-adjacent segments, scans Annex-B over the virtual ES
    stream, and maps each NAL back to file segments (the TS/PS common
    machinery; NALs split across packets carry a `segs` list)."""
    # merge file-adjacent segments, build the virtual ES stream
    merged = [list(es[0])]
    for o, l in es[1:]:
        if merged[-1][0] + merged[-1][1] == o:
            merged[-1][1] += l
        else:
            merged.append([o, l])
    es = [(o, l) for o, l in merged]
    buf = b"".join(bytes(data[o : o + l]) for o, l in es)
    cum = [0]
    for _, l in es:
        cum.append(cum[-1] + l)

    def v2segs(vs, ve):
        """Virtual ES range -> merged file segments."""
        segs = []
        i = bisect.bisect_right(cum, vs) - 1
        while vs < ve:
            o, l = es[i]
            take = min(ve - vs, cum[i + 1] - vs)
            segs.append((o + (vs - cum[i]), take))
            vs += take
            i += 1
        return segs

    # Annex-B scan over the virtual stream
    starts = []
    vn = len(buf)
    i = 0
    while i + 3 <= vn:
        if buf[i] == 0 and buf[i + 1] == 0:
            if buf[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if i + 4 <= vn and buf[i + 2] == 0 and buf[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    if not starts:
        return None
    sps, pps, nals = [], [], []
    for k, s in enumerate(starts):
        if k + 1 == len(starts):
            e = vn
        else:
            e = starts[k + 1] - 3
            if e - 1 >= s and buf[e - 1] == 0:
                e -= 1
        # encoders pad ES with trailing zero bytes; NAL syntax never ends in
        # 0x00, so strip them (they stay in the file as gap/literal bytes)
        while e > s + 1 and buf[e - 1] == 0:
            e -= 1
        if e <= s:
            continue
        hdr = buf[s]
        segs = v2segs(s, e)
        span = nal_span(segs[0][0], e - s, hdr & 0x1F, (hdr >> 5) & 3)
        if len(segs) > 1:
            span.segs = segs
        nals.append(span)
        if span.nal_type == 7:
            sps.append(buf[s:e])
        elif span.nal_type == 8:
            pps.append(buf[s:e])
    return sps, pps, nals
