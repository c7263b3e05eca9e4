"""Stream-level slice walking: parameter-set tracking, picture state ring,
and per-slice parse orchestration shared by compress/decompress/validate.

The picture ring (cur/prev PicState) is the analog of the reference's
FrameBuffer frames[2] ping-pong (recode.cpp:630-631, 831-850).
"""

from dataclasses import dataclass

from ..utils.bitio import unescape_rbsp
from ..utils.mp4 import demux, nal_payload, nal_span_end
from .coders import CompressCoder
from .mbparse import PicState, SliceParser, ParseDesync
from .params import UnsupportedStream, mb_height, parse_pps, parse_sps
from .slicehdr import parse_slice_header


@dataclass
class SliceRecord:
    nal_index: int
    offset: int  # absolute file offset of NAL start
    size: int  # total NAL byte length (sum of segments for TS)
    header: object
    sps: object
    pps: object
    rbsp: bytes  # unescaped NAL payload (incl. nal header byte)
    cabac_offset: int  # offset of CABAC data within rbsp
    segs: list = None  # (file_off, len) pieces for non-contiguous NALs (TS)
    span_end: int = 0  # file offset one past the NAL's last byte


class StreamWalker:
    """Iterates a file's slice NALs in decode order, maintaining SPS/PPS maps
    and the cur/prev picture-state ring."""

    def __init__(self, data):
        self.data = data
        self.stream = demux(bytes(data))
        self.sps_map = {}
        self.pps_map = {}
        self.cur_pic = None
        self.prev_pic = None
        self.slice_id = 0
        # raw bytes of the version in effect per id: an in-band REdefinition
        # with different content poisons recoding from that point (the
        # container stores one version per id; decompress uses first-wins)
        self.sps_raw = {}
        self.pps_raw = {}
        self.params_poisoned = False
        # ordered list of every distinct parameter-set NAL seen (initial +
        # in-band): the container must carry all sets recoded slices may
        # reference; decompress applies first-definition-wins
        self.all_sps = []
        self.all_pps = []
        if self.stream is not None:
            for sps in self.stream.sps_list:
                try:
                    s = parse_sps(sps)
                    self.sps_map[s.sps_id] = s
                    self.sps_raw.setdefault(s.sps_id, bytes(sps))
                    self._collect(self.all_sps, bytes(sps))
                except Exception:
                    pass
            for pps in self.stream.pps_list:
                try:
                    p = parse_pps(pps, self.sps_map)
                    self.pps_map[p.pps_id] = p
                    self.pps_raw.setdefault(p.pps_id, bytes(pps))
                    self._collect(self.all_pps, bytes(pps))
                except Exception:
                    pass

    @staticmethod
    def _collect(lst, b):
        if b not in lst:
            lst.append(b)

    def slices(self):
        """Yield SliceRecord for each parseable coded-slice NAL.

        Unparseable slices (unsupported features) are skipped — the caller's
        literal fallback covers them.  SPS/PPS NALs encountered mid-stream
        update the maps (in-band parameter sets)."""
        if self.stream is None:
            return
        for i, nal in enumerate(self.stream.nals):
            raw = nal_payload(self.data, nal)
            if nal.nal_type == 7:
                try:
                    s = parse_sps(raw)
                    prev_raw = self.sps_raw.get(s.sps_id)
                    if prev_raw is not None and prev_raw != bytes(raw):
                        self.params_poisoned = True  # conflicting update
                    self.sps_map[s.sps_id] = s
                    self.sps_raw.setdefault(s.sps_id, bytes(raw))
                    self._collect(self.all_sps, bytes(raw))
                except Exception:
                    pass
                continue
            if nal.nal_type == 8:
                try:
                    p = parse_pps(raw, self.sps_map)
                    prev_raw = self.pps_raw.get(p.pps_id)
                    if prev_raw is not None and prev_raw != bytes(raw):
                        self.params_poisoned = True
                    self.pps_map[p.pps_id] = p
                    self.pps_raw.setdefault(p.pps_id, bytes(raw))
                    self._collect(self.all_pps, bytes(raw))
                except Exception:
                    pass
                continue
            if nal.nal_type not in (1, 5):
                continue
            if self.params_poisoned:
                continue  # conflicting in-band parameter update: literal-only
            try:
                rbsp = unescape_rbsp(raw[1:])
                hdr, sps, pps = parse_slice_header(
                    rbsp, nal.nal_type, nal.nal_ref_idc, self.sps_map, self.pps_map
                )
            except (UnsupportedStream, EOFError, ValueError):
                continue
            yield SliceRecord(
                nal_index=i,
                offset=nal.offset,
                size=nal.size,
                header=hdr,
                sps=sps,
                pps=pps,
                rbsp=b"\x00" + rbsp,  # keep 1-byte header placeholder offset
                cabac_offset=1 + hdr.cabac_start_byte,
                segs=nal.segs,
                span_end=nal_span_end(nal),
            )

    def picture_for(self, rec):
        """Return (cur, prev) PicState for this slice, advancing the ring on
        picture boundaries (first_mb_in_slice == 0)."""
        if rec.header.first_mb_in_slice == 0 or self.cur_pic is None:
            self.prev_pic = self.cur_pic
            self.cur_pic = PicState(rec.sps.pic_width_in_mbs,
                                    mb_height(rec.sps) >> int(rec.header.field_pic))
        self.slice_id += 1
        return self.cur_pic, self.prev_pic

    def make_parser(self, rec, coder):
        cur, prev = self.picture_for(rec)
        return SliceParser(rec.sps, rec.pps, rec.header, cur, prev, coder, self.slice_id)


def validate_file(data, max_slices=None, collect=None):
    """Parse every slice with a verification-only CompressCoder.

    Returns stats dict: slices attempted/parsed/byte-exact, bins, fallbacks.
    This is the bring-up oracle for the parser: on a conformant encoder's
    output every slice must parse to completion AND re-encode to a byte
    prefix of the original payload."""
    w = StreamWalker(data)
    stats = {
        "slices": 0,
        "parsed": 0,
        "byte_exact": 0,
        "bins": 0,
        "errors": [],
    }
    for rec in w.slices():
        if max_slices is not None and stats["slices"] >= max_slices:
            break
        stats["slices"] += 1
        payload = rec.rbsp[rec.cabac_offset :]
        coder = CompressCoder(
            payload,
            rec.header.slice_qp,
            None if rec.header.slice_type in (2, 4) else rec.header.cabac_init_idc,
        )
        parser = w.make_parser(rec, coder)
        try:
            n_mbs = parser.parse_slice_data()
        except (UnsupportedStream, ParseDesync, EOFError, AssertionError) as e:
            stats["errors"].append((rec.nal_index, repr(e)))
            continue
        stats["parsed"] += 1
        stats["bins"] += coder.n_bins
        ok, _drop, tail = coder.verify_tail()
        if ok:
            stats["byte_exact"] += 1
            stats["tail_bytes"] = stats.get("tail_bytes", 0) + len(tail)
        else:
            tail = None
            stats["errors"].append((rec.nal_index, "re-encode mismatch"))
        if collect is not None:
            collect.append((rec, n_mbs, tail, coder))
    return stats
