"""Matroska/WebM demux: locate H.264 NAL units by absolute file offset.

Extends demux breadth toward the reference's libavformat surface
(recode.cpp:89-96): an MKV rewrap of the same AVC stream must recode with
the same ratio as the MP4 original.  Only the byte layout is needed —
TrackEntry gives the avcC (CodecPrivate) with the NAL length-prefix size,
and every (Simple)Block frame carries length-prefixed NALs contiguously in
the file, so the existing contiguous NalSpan model applies unchanged.
"""


def _vint(data, pos, keep_marker):
    """EBML variable-length integer at pos -> (value, next_pos).
    keep_marker=True for element IDs (marker bit retained)."""
    if pos >= len(data):
        raise EOFError
    b0 = data[pos]
    if b0 == 0:
        raise ValueError("invalid EBML vint")
    length = 1
    mask = 0x80
    while not (b0 & mask):
        length += 1
        mask >>= 1
    if pos + length > len(data):
        raise EOFError
    v = b0 if keep_marker else (b0 & (mask - 1))
    unknown = (b0 & (mask - 1)) == mask - 1
    for i in range(1, length):
        byte = data[pos + i]
        v = (v << 8) | byte
        unknown = unknown and byte == 0xFF
    if not keep_marker and unknown:
        v = -1  # unknown size
    return v, pos + length


def _elements(data, start, end):
    """Iterate (element_id, body_start, body_end) within [start, end)."""
    pos = start
    while pos < end:
        try:
            eid, p = _vint(data, pos, True)
            size, body = _vint(data, p, False)
        except (EOFError, ValueError):
            return
        if size < 0:  # unknown size: element extends to parent end
            yield eid, body, end
            return
        if body + size > end:
            return
        yield eid, body, body + size
        pos = body + size


EBML = 0x1A45DFA3
SEGMENT = 0x18538067
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
CLUSTER = 0x1F43B675
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1


def _uint(data, s, e):
    v = 0
    for i in range(s, e):
        v = (v << 8) | data[i]
    return v


def _find_avc_track(data, seg_s, seg_e, parse_avcc):
    for eid, s, e in _elements(data, seg_s, seg_e):
        if eid != TRACKS:
            continue
        for tid, ts, te in _elements(data, s, e):
            if tid != TRACK_ENTRY:
                continue
            num = None
            codec = None
            private = None
            for fid, fs, fe in _elements(data, ts, te):
                if fid == TRACK_NUMBER:
                    num = _uint(data, fs, fe)
                elif fid == CODEC_ID:
                    codec = bytes(data[fs:fe]).rstrip(b"\x00")
                elif fid == CODEC_PRIVATE:
                    private = bytes(data[fs:fe])
            if codec == b"V_MPEG4/ISO/AVC" and num is not None and private:
                return num, parse_avcc(private)
    return None


def _block_frames(data, s, e, want_track):
    """Frame byte ranges [(off, end)] of a (Simple)Block for want_track."""
    track, p = _vint(data, s, False)
    if track != want_track or p + 3 > e:
        return []
    flags = data[p + 2]
    p += 3
    lacing = (flags >> 1) & 3
    if lacing == 0:
        return [(p, e)]
    if p >= e:
        return []
    n_frames = data[p] + 1
    p += 1
    sizes = []
    if lacing == 2:  # fixed
        total = e - p
        if total % n_frames:
            return []
        sizes = [total // n_frames] * (n_frames - 1)
    elif lacing == 1:  # Xiph
        for _ in range(n_frames - 1):
            v = 0
            while p < e:
                v += data[p]
                if data[p] != 255:
                    p += 1
                    break
                p += 1
            sizes.append(v)
    else:  # EBML lacing: first absolute, rest signed deltas
        first, p = _vint(data, p, False)
        sizes.append(first)
        for _ in range(n_frames - 2):
            raw_pos = p
            b0 = data[p]
            length = 1
            mask = 0x80
            while not (b0 & mask):
                length += 1
                mask >>= 1
            v, p = _vint(data, raw_pos, False)
            bias = (1 << (7 * length - 1)) - 1
            sizes.append(sizes[-1] + v - bias)
    frames = []
    for sz in sizes:
        if sz < 0 or p + sz > e:
            return []
        frames.append((p, p + sz))
        p += sz
    frames.append((p, e))  # last frame: remainder
    return frames


def demux_mkv(data, nal_span, parse_avcc):
    """Parse a Matroska file.  nal_span(offset, size, nal_type, nal_ref_idc)
    constructs spans; parse_avcc(bytes) -> (length_size, sps_list, pps_list).
    Returns (sps, pps, nals) or None."""
    segments = [
        (s, e) for eid, s, e in _elements(data, 0, len(data)) if eid == SEGMENT
    ]
    if not segments:
        return None
    seg_s, seg_e = segments[0]
    track = _find_avc_track(data, seg_s, seg_e, parse_avcc)
    if track is None:
        return None
    want, (length_size, sps, pps) = track
    nals = []
    for eid, cs, ce in _elements(data, seg_s, seg_e):
        if eid != CLUSTER:
            continue
        for bid, bs, be in _elements(data, cs, ce):
            blocks = []
            if bid == SIMPLE_BLOCK:
                blocks.append((bs, be))
            elif bid == BLOCK_GROUP:
                blocks.extend(
                    (s, e) for gid, s, e in _elements(data, bs, be) if gid == BLOCK
                )
            for s, e in blocks:
                try:
                    frames = _block_frames(data, s, e, want)
                except (EOFError, ValueError, IndexError):
                    continue
                for fs, fe in frames:
                    pos = fs
                    while pos + length_size <= fe:
                        ln = _uint(data, pos, pos + length_size)
                        pos += length_size
                        if ln == 0 or pos + ln > fe:
                            break
                        hdr = data[pos]
                        nals.append(
                            nal_span(pos, ln, hdr & 0x1F, (hdr >> 5) & 3)
                        )
                        pos += ln
    return sps, pps, nals
