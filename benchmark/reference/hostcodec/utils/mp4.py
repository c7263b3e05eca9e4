"""Container demux: locate H.264 NAL units (by absolute file offset) plus
SPS/PPS, for ISO-BMFF (MP4/MOV) and Annex-B elementary streams.

Replaces the reference's libavformat demux + memmem payload search
(recode.cpp:89-96, 1282-1290): instead of string-searching the file for the
slice payload ffmpeg handed us, we read the sample tables, so every NAL's
byte range is known exactly — O(index) instead of O(file_size * slices).

Only the byte *layout* is needed (the recoder never touches pixels): the
demuxer returns NalSpan(offset, size, header_offset) records; all other file
bytes pass through as literals.
"""

import struct
from dataclasses import dataclass


@dataclass
class NalSpan:
    """One NAL unit in the file. offset/size cover the NAL payload itself
    (starting at the nal header byte), excluding start code / length prefix."""

    offset: int
    size: int
    nal_type: int
    nal_ref_idc: int
    # non-contiguous NALs (MPEG-TS): list of (file_offset, length) pieces
    # whose lengths sum to `size`; None = contiguous at [offset, offset+size)
    segs: list = None


@dataclass
class H264Stream:
    sps_list: list  # raw RBSP-escaped SPS NAL payloads (without header byte? no: full NAL incl header)
    pps_list: list
    nals: list  # NalSpan for every video NAL in file order


SLICE_TYPES = (1, 2, 5)  # non-IDR, partition A (unsupported->fallback), IDR


def nal_payload(data, span):
    """NAL bytes (header byte included), concatenating TS segments."""
    if span.segs is None:
        return data[span.offset : span.offset + span.size]
    return b"".join(bytes(data[o : o + l]) for o, l in span.segs)


def nal_span_end(span):
    """File offset one past the NAL's last byte (spans its gaps for TS)."""
    if span.segs is None:
        return span.offset + span.size
    o, l = span.segs[-1]
    return o + l


def _boxes(data, start, end):
    """Iterate (type, body_start, body_end) over ISO-BMFF boxes."""
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos : pos + 4])[0]
        btype = data[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8 : pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            break
        yield btype, pos + hdr, pos + size
        pos += size


def _find_box(data, start, end, path):
    """Find first box at path like [b'moov', b'trak', ...]. Returns (s, e)."""
    if not path:
        return start, end
    for btype, s, e in _boxes(data, start, end):
        if btype == path[0]:
            r = _find_box(data, s, e, path[1:])
            if r:
                return r
    return None


def _parse_stbl(data, stbl_s, stbl_e):
    tables = {}
    for btype, s, e in _boxes(data, stbl_s, stbl_e):
        tables[btype] = (s, e)
    return tables


def _parse_avcc(avcc):
    """avcC box body -> (length_size, sps_list, pps_list)."""
    assert avcc[0] == 1, "avcC configurationVersion"
    length_size = (avcc[4] & 3) + 1
    pos = 5
    n_sps = avcc[pos] & 0x1F
    pos += 1
    sps = []
    for _ in range(n_sps):
        ln = struct.unpack(">H", avcc[pos : pos + 2])[0]
        pos += 2
        sps.append(avcc[pos : pos + ln])
        pos += ln
    n_pps = avcc[pos]
    pos += 1
    pps = []
    for _ in range(n_pps):
        ln = struct.unpack(">H", avcc[pos : pos + 2])[0]
        pos += 2
        pps.append(avcc[pos : pos + ln])
        pos += ln
    return length_size, sps, pps


def _sample_sizes(data, tables, count):
    s, e = tables[b"stsz"]
    uniform, n = struct.unpack(">II", data[s + 4 : s + 12])
    if uniform:
        return [uniform] * n
    return list(struct.unpack(f">{n}I", data[s + 12 : s + 12 + 4 * n]))


def _chunk_offsets(data, tables):
    if b"stco" in tables:
        s, e = tables[b"stco"]
        n = struct.unpack(">I", data[s + 4 : s + 8])[0]
        return list(struct.unpack(f">{n}I", data[s + 8 : s + 8 + 4 * n]))
    s, e = tables[b"co64"]
    n = struct.unpack(">I", data[s + 4 : s + 8])[0]
    return list(struct.unpack(f">{n}Q", data[s + 8 : s + 8 + 8 * n]))


def _stsc(data, tables):
    s, e = tables[b"stsc"]
    n = struct.unpack(">I", data[s + 4 : s + 8])[0]
    ents = []
    for i in range(n):
        first_chunk, spc, sdi = struct.unpack(
            ">III", data[s + 8 + 12 * i : s + 20 + 12 * i]
        )
        ents.append((first_chunk, spc))
    return ents


def _sample_offsets(data, tables):
    """Absolute file offset of each sample, in sample order."""
    sizes = _sample_sizes(data, tables, None)
    chunks = _chunk_offsets(data, tables)
    stsc = _stsc(data, tables)
    offsets = []
    si = 0
    for ci, chunk_off in enumerate(chunks):
        # samples-per-chunk for this chunk
        spc = 1
        for first_chunk, v in stsc:
            if ci + 1 >= first_chunk:
                spc = v
            else:
                break
        pos = chunk_off
        for _ in range(spc):
            if si >= len(sizes):
                break
            offsets.append(pos)
            pos += sizes[si]
            si += 1
    return offsets, sizes


def _track_id(data, trak_s, trak_e):
    """track_id from tkhd (None if absent/corrupt)."""
    tkhd = _find_box(data, trak_s, trak_e, [b"tkhd"])
    if not tkhd:
        return None
    s, e = tkhd
    if s >= e:
        return None
    ver = data[s]
    off = s + 4 + (16 if ver else 8)  # ver/flags + ctime + mtime
    if off + 4 > e:
        return None
    return struct.unpack(">I", data[off : off + 4])[0]


def _trex_defaults(data, moov_s, moov_e, track_id):
    """trex default_sample_size for the track (0 if none)."""
    mvex = _find_box(data, moov_s, moov_e, [b"mvex"])
    if not mvex:
        return 0
    for btype, s, e in _boxes(data, mvex[0], mvex[1]):
        if btype != b"trex" or s + 24 > e:
            continue
        tid, _sdi, _dur, dsize = struct.unpack(">IIII", data[s + 4 : s + 20])
        if tid == track_id:
            return dsize
    return 0


def _fragment_samples(data, track_id, trex_size):
    """Walk top-level moof boxes -> (offset, size) per sample, file order.

    Covers the DASH/CMAF layouts the reference gets from libavformat
    (recode.cpp:89-96): tfhd base_data_offset / default-base-is-moof /
    implicit moof-start base, tfhd+trex default sample sizes, multi-trun
    trafs with implicit continuation offsets."""
    samples = []
    pos0 = 0
    tops = []  # (box_start, body_start, body_end) of top-level moofs
    while pos0 + 8 <= len(data):
        size = struct.unpack(">I", data[pos0 : pos0 + 4])[0]
        btype = data[pos0 + 4 : pos0 + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos0 + 8 : pos0 + 16])[0]
            hdr = 16
        elif size == 0:
            size = len(data) - pos0
        if size < hdr or pos0 + size > len(data):
            break
        if btype == b"moof":
            tops.append((pos0, pos0 + hdr, pos0 + size))
        pos0 += size
    for moof_start, moof_s, moof_e in tops:
        traf_base_next = None  # end of previous traf's data (implicit base)
        for t2, traf_s, traf_e in _boxes(data, moof_s, moof_e):
            if t2 != b"traf":
                continue
            tfhd = _find_box(data, traf_s, traf_e, [b"tfhd"])
            if not tfhd:
                continue
            s, e = tfhd
            flags = struct.unpack(">I", data[s : s + 4])[0] & 0xFFFFFF
            tid = struct.unpack(">I", data[s + 4 : s + 8])[0]
            pos = s + 8
            base = None
            if flags & 0x01:
                base = struct.unpack(">Q", data[pos : pos + 8])[0]
                pos += 8
            if flags & 0x02:
                pos += 4
            if flags & 0x08:
                pos += 4
            dsize = trex_size
            if flags & 0x10:
                dsize = struct.unpack(">I", data[pos : pos + 4])[0]
                pos += 4
            if base is None:
                if flags & 0x20000:  # default-base-is-moof
                    base = moof_start
                else:
                    base = (moof_start if traf_base_next is None
                            else traf_base_next)
            if tid != track_id:
                continue
            run_pos = None
            for t3, trun_s, trun_e in _boxes(data, traf_s, traf_e):
                if t3 != b"trun":
                    continue
                s3 = trun_s
                tf = struct.unpack(">I", data[s3 : s3 + 4])[0] & 0xFFFFFF
                count = struct.unpack(">I", data[s3 + 4 : s3 + 8])[0]
                p = s3 + 8
                if tf & 0x01:
                    doff = struct.unpack(">i", data[p : p + 4])[0]
                    run_pos = base + doff
                    p += 4
                elif run_pos is None:
                    run_pos = base
                if tf & 0x04:
                    p += 4
                per = ((4 if tf & 0x100 else 0) + (4 if tf & 0x200 else 0)
                       + (4 if tf & 0x400 else 0) + (4 if tf & 0x800 else 0))
                for i in range(count):
                    size = dsize
                    q = p + i * per
                    if tf & 0x100:
                        q += 4
                    if tf & 0x200:
                        size = struct.unpack(">I", data[q : q + 4])[0]
                    if size <= 0 or run_pos + size > len(data):
                        return samples  # corrupt tail: keep what we have
                    samples.append((run_pos, size))
                    run_pos += size
            traf_base_next = run_pos if run_pos is not None else base
    return samples


def _is_avc_track(data, trak_s, trak_e):
    stsd = _find_box(data, trak_s, trak_e, [b"mdia", b"minf", b"stbl", b"stsd"])
    if not stsd:
        return None
    s, e = stsd
    for btype, bs, be in _boxes(data, s + 8, e):
        if btype in (b"avc1", b"avc3"):
            # visual sample entry: 78 bytes of fields before sub-boxes
            for sb, ss, se in _boxes(data, bs + 78, be):
                if sb == b"avcC":
                    return data[ss:se]
    return None


def demux_mp4(data):
    """Parse an MP4 file -> H264Stream, or None if no AVC track."""
    moov = _find_box(data, 0, len(data), [b"moov"])
    if not moov:
        return None
    for btype, trak_s, trak_e in _boxes(data, moov[0], moov[1]):
        if btype != b"trak":
            continue
        avcc = _is_avc_track(data, trak_s, trak_e)
        if avcc is None:
            continue
        length_size, sps, pps = _parse_avcc(avcc)
        stbl = _find_box(data, trak_s, trak_e, [b"mdia", b"minf", b"stbl"])
        tables = _parse_stbl(data, stbl[0], stbl[1])
        offsets, sizes = _sample_offsets(data, tables)
        samples = list(zip(offsets, sizes))
        # fragmented MP4 (DASH/CMAF): the rest of (or all of) the samples
        # live in moof/traf/trun fragments after the (possibly empty) moov
        tid = _track_id(data, trak_s, trak_e)
        if tid is not None:
            trex_size = _trex_defaults(data, moov[0], moov[1], tid)
            samples += _fragment_samples(data, tid, trex_size)
        nals = []
        for off, size in samples:
            pos = off
            end = off + size
            while pos + length_size <= end:
                if length_size == 4:
                    ln = struct.unpack(">I", data[pos : pos + 4])[0]
                elif length_size == 2:
                    ln = struct.unpack(">H", data[pos : pos + 2])[0]
                else:
                    ln = data[pos]
                pos += length_size
                if ln == 0 or pos + ln > end:
                    break
                hdr = data[pos]
                nals.append(
                    NalSpan(pos, ln, nal_type=hdr & 0x1F, nal_ref_idc=(hdr >> 5) & 3)
                )
                pos += ln
        return H264Stream(sps_list=sps, pps_list=pps, nals=nals)
    return None


def demux_annexb(data):
    """Parse an Annex-B elementary stream -> H264Stream."""
    nals = []
    sps, pps = [], []
    n = len(data)
    # find start codes
    starts = []
    i = 0
    while i + 3 <= n:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if i + 4 <= n and data[i + 2] == 0 and data[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    if not starts:
        return None
    for k, s in enumerate(starts):
        if k + 1 == len(starts):
            e = n
        else:
            e = starts[k + 1] - 3  # 3-byte prefix
            if e - 1 >= s and data[e - 1] == 0:
                e -= 1  # 4-byte prefix (leading zero)
        if e <= s:
            continue
        hdr = data[s]
        span = NalSpan(s, e - s, nal_type=hdr & 0x1F, nal_ref_idc=(hdr >> 5) & 3)
        nals.append(span)
        if span.nal_type == 7:
            sps.append(bytes(data[s:e]))
        elif span.nal_type == 8:
            pps.append(bytes(data[s:e]))
    return H264Stream(sps_list=sps, pps_list=pps, nals=nals)


def demux_mkv_file(data):
    from .mkv import demux_mkv

    def mk_avcc(private):
        return _parse_avcc(private)

    r = demux_mkv(data, NalSpan, mk_avcc)
    if r is None:
        return None
    sps, pps, nals = r
    return H264Stream(sps_list=sps, pps_list=pps, nals=nals)


def demux(data):
    """Auto-detect container type."""
    if len(data) > 12 and data[4:8] in (b"ftyp", b"moov", b"mdat", b"wide", b"free"):
        stream = demux_mp4(data)
        if stream:
            return stream
    if len(data) > 8 and data[:4] == b"\x1aE\xdf\xa3":  # EBML -> Matroska
        stream = demux_mkv_file(data)
        if stream:
            return stream
    if len(data) >= 188 * 4 and data[0] == 0x47:  # MPEG-TS sync
        from .ts import demux_ts

        r = demux_ts(data, NalSpan)
        if r:
            sps, pps, nals = r
            return H264Stream(sps_list=sps, pps_list=pps, nals=nals)
    if len(data) > 12 and data[:4] == b"RIFF" and data[8:12] == b"AVI ":
        from .avi import demux_avi

        r = demux_avi(data, NalSpan)
        if r:
            sps, pps, nals = r
            return H264Stream(sps_list=sps, pps_list=pps, nals=nals)
    if len(data) > 13 and data[:3] == b"FLV":
        from .flv import demux_flv

        r = demux_flv(data, NalSpan, _parse_avcc)
        if r:
            sps, pps, nals = r
            return H264Stream(sps_list=sps, pps_list=pps, nals=nals)
    if len(data) > 16 and data[:4] == b"\x00\x00\x01\xba":  # MPEG-PS pack
        from .ps import demux_ps

        r = demux_ps(data, NalSpan)
        if r:
            sps, pps, nals = r
            return H264Stream(sps_list=sps, pps_list=pps, nals=nals)
    return demux_annexb(data)
