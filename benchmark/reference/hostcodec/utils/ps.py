"""MPEG program-stream (PS) demux — the last container the reference's
libavformat front end would accept that we did not own natively
(recode.cpp:89-96; VERDICT round-4 "minor container residue").

PS wraps H.264 as Annex-B inside video PES packets (stream ids
0xE0-0xEF) between pack headers; like MPEG-TS, a NAL can span PES
packets, so the demuxer collects video payload segments and rides the
shared virtual-ES machinery (utils/ts.py es_to_nals) — split NALs carry
`segs` and the container re-scatters them byte-exactly at decompress.
"""

from .ts import es_to_nals


def demux_ps(data, nal_span):
    n = len(data)
    if n < 16 or data[0] != 0 or data[1] != 0 or data[2] != 1 or \
            data[3] != 0xBA:
        return None
    es = []  # (file_off, len) video PES payload segments in stream order
    pos = 0
    while pos + 4 <= n:
        if not (data[pos] == 0 and data[pos + 1] == 0 and
                data[pos + 2] == 1):
            pos += 1  # resync (stuffing/garbage between packs)
            continue
        sid = data[pos + 3]
        if sid == 0xBA:  # pack header
            if pos + 14 > n:
                break
            if (data[pos + 4] >> 6) == 1:  # MPEG-2: '01' marker
                stuff = data[pos + 13] & 7
                pos += 14 + stuff
            else:  # MPEG-1 pack: fixed 12 bytes
                pos += 12
            continue
        if sid == 0xB9:  # program end
            break
        if pos + 6 > n:
            break
        plen = (data[pos + 4] << 8) | data[pos + 5]
        body = pos + 6
        end = min(body + plen, n)
        if 0xE0 <= sid <= 0xEF and body + 3 <= end:
            if (data[body] >> 6) == 2:  # MPEG-2 PES header
                hl = data[body + 2]
                payload = body + 3 + hl
            else:  # MPEG-1: stuffing 0xFF*, optional STD, PTS/DTS
                q = body
                while q < end and data[q] == 0xFF:
                    q += 1
                if q < end and (data[q] >> 6) == 1:
                    q += 2  # STD buffer
                if q < end and (data[q] >> 4) == 2:
                    q += 5
                elif q < end and (data[q] >> 4) == 3:
                    q += 10
                else:
                    q += 1  # '0000 1111' no-timestamp marker
                payload = q
            if payload < end:
                es.append((payload, end - payload))
        pos = end if plen else pos + 6
    if not es:
        return None
    return es_to_nals(data, es, nal_span)
