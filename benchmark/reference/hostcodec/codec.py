"""Compress / decompress entry points — the reference's C10/C11 equivalents.

compress(data)   -> recoded container bytes (self-verifying: every recoded
                    slice is re-encoded and byte-compared during compression;
                    any mismatch falls back to a literal block, so
                    decompress(compress(x)) == x holds for ANY input).
decompress(blob) -> original file bytes.

Compression pipeline per slice:
  1. validation pass on a scratch copy of the picture state (parse + CABAC
     re-encode prefix/tail check) — cheap insurance replacing the
     reference's skip_coded heuristics (recode.cpp:1296-1303),
  2. model pass on the real state: bins re-coded through the adaptive model
     into the shared range-coder stream; model snapshot/rollback protects
     against desync raising mid-slice.
"""

import copy

from .h264.cavlc import (
    CavlcCompressCoder,
    CavlcDecompressCoder,
    CavlcSliceParser,
)
from .h264.coders import CompressCoder, DecompressCoder
from .h264.mbparse import ParseDesync, PicState
from .h264.params import UnsupportedStream, mb_height, parse_pps, parse_sps
from .h264.slicehdr import parse_slice_header
from .h264.stream import StreamWalker
from .h264.mbparse import SliceParser
from .models.h264_model import RecodeModel
from .utils.bitio import escape_rbsp
from .utils.mp4 import nal_payload
from .utils.container import (
    ContainerError,
    KIND_END,
    KIND_LITERAL,
    KIND_SLICE,
    MAGIC,
    Reader,
    SCOPE_GOP,
    SCOPE_SLICE,
    SCOPE_STREAM,
    VERSION,
    Writer,
)


def _try_slice(rec, cur_pic, prev_pic, slice_id, model, isolate=False):
    """Model-pass parse of one slice. Returns (mb_count, tail) or raises."""
    if rec.header.cavlc:
        # CAVLC slices model the bitstream bits themselves (cavlc.py):
        # regeneration is identity by construction, so there is no
        # re-encode verification step — only the trailing-bits check
        coder = CavlcCompressCoder(rec.rbsp[1:], rec.header.data_bit_offset,
                                   model=model)
        parser = CavlcSliceParser(
            rec.sps, rec.pps, rec.header, cur_pic, prev_pic, coder,
            slice_id, isolate=isolate
        )
        n_mbs = parser.parse_slice_data()
        tail = coder.finish()
        return n_mbs, 0, tail, coder
    payload = rec.rbsp[rec.cabac_offset :]
    idc = None if rec.header.slice_type in (2, 4) else rec.header.cabac_init_idc
    coder = CompressCoder(payload, rec.header.slice_qp, idc, model=model)
    parser = SliceParser(
        rec.sps, rec.pps, rec.header, cur_pic, prev_pic, coder, slice_id, isolate=isolate
    )
    n_mbs = parser.parse_slice_data()
    ok, drop, tail = coder.verify_tail()
    if not ok:
        raise ParseDesync("re-encode mismatch")
    return n_mbs, drop, tail, coder


SCOPE_NAMES = {"stream": SCOPE_STREAM, "slice": SCOPE_SLICE, "gop": SCOPE_GOP}


def compress(data, verbose=False, scope="stream", slice_model_factory=None,
             substream_bins=0):
    """Compress with total-function semantics: any failure anywhere in
    demux/parse degrades to literal passthrough, never an error.

    scope='stream': one adaptive model over the file (best ratio, serial).
    scope='slice' : model reset + separate range stream per slice with
                    isolated priors — slices of a picture are independently
                    decodable, the unit of device/mesh parallelism.
    """
    data = bytes(data)
    try:
        return _compress_inner(
            data,
            verbose,
            scope=SCOPE_NAMES.get(scope, scope),
            slice_model_factory=slice_model_factory,
            substream_bins=substream_bins,
        )
    except Exception:
        out = Writer()
        out.out += MAGIC
        out.u8(VERSION)
        out.u8(0)
        out.u16(SCOPE_STREAM)
        out.varint(0)  # substream_bins
        out.varint(0)
        out.varint(0)
        if data:
            out.u8(KIND_LITERAL)
            out.blob(data)
        out.u8(KIND_END)
        out.blob(RecodeModel("encode").finish())
        return out.bytes()


def _scan_blocks(data, scope, slice_model_factory, stats, cabac_bill,
                 substream_bins=0):
    """Walk the file, parse/verify every slice, build the block list.

    Per-slice-scope slice blocks carry the finished per-slice MODEL OBJECT in
    the sstream position (finished to bytes at serialization) so the device
    pipeline can batch-encode traces.  GOP scope resets the model and the
    picture-prior ring at IDR pictures; the GOP's stream rides the sstream
    slot of its first slice block.  Returns (sps_list, pps_list, blocks,
    stream_model)."""
    per_slice = scope == SCOPE_SLICE
    per_gop = scope == SCOPE_GOP
    w = StreamWalker(data)

    B = substream_bins
    model = RecodeModel("encode", substream_bins=B) if not per_gop else None
    blocks = []  # (kind, payload...)
    pos = 0

    for rec in w.slices():
        stats["slices"] += 1
        if per_slice:
            model = (slice_model_factory
                     or (lambda: RecodeModel("encode", substream_bins=B)))()
        gop_start = per_gop and (
            model is None
            or (rec.header.idr and rec.header.first_mb_in_slice == 0)
        )
        if gop_start:
            # fresh GOP: new model + wiped picture ring (no priors cross
            # the IDR), making GOPs independently decodable units
            model = (slice_model_factory
                     or (lambda: RecodeModel("encode", substream_bins=B)))()
            model._gop_emitted = False
            w.cur_pic = None
            w.prev_pic = None
        # picture ring advance must mirror decompression exactly: only
        # recoded slices advance/write state, so decide fallback first
        # using scratch copies.
        advance = rec.header.first_mb_in_slice == 0 or w.cur_pic is None
        if advance:
            cand_prev = w.cur_pic
            # PAFF field picture: a half-height picture of its own
            cand_cur = PicState(rec.sps.pic_width_in_mbs,
                                mb_height(rec.sps) >> int(rec.header.field_pic))
        else:
            cand_prev = w.prev_pic
            cand_cur = w.cur_pic

        # canonical-escaping check: decompress rebuilds the NAL with
        # escape_rbsp, so the original must round-trip through it
        nal_bytes = bytes(nal_payload(data, rec))
        if nal_bytes[0:1] + escape_rbsp(rec.rbsp[1:]) != nal_bytes:
            continue  # non-canonical escaping: leave in literal stream

        snap = None if per_slice else model.snapshot()
        scratch_cur = copy.deepcopy(cand_cur)
        sid = w.slice_id + 1
        try:
            n_mbs, drop, tail, coder = _try_slice(
                rec, scratch_cur, cand_prev, sid, model, isolate=per_slice
            )
        except (UnsupportedStream, ParseDesync, EOFError, AssertionError, ValueError):
            if snap is not None:
                model.rollback(snap)
            continue  # slice stays inside literal stream

        # commit: replace state with scratch (parsed), advance ring
        if advance:
            w.prev_pic = cand_prev
        w.cur_pic = scratch_cur
        w.slice_id = sid
        stats["recoded"] += 1
        stats["bins"] += coder.n_bins
        for k, v in coder.cabac_bill.items():
            cabac_bill[k] = cabac_bill.get(k, 0) + v

        # emit literal up to this NAL, then the slice block
        if rec.offset > pos:
            blocks.append((KIND_LITERAL, data[pos : rec.offset]))
        head = rec.rbsp[: rec.cabac_offset]
        head = nal_bytes[0:1] + head[1:]  # real NAL header byte
        # non-contiguous NAL (MPEG-TS): record per-segment lengths and the
        # in-span gap bytes so decompress can re-scatter the rebuilt NAL
        gaps = []
        if rec.segs:
            for si in range(len(rec.segs) - 1):
                o, ln = rec.segs[si]
                no, _ = rec.segs[si + 1]
                gaps.append((ln, bytes(data[o + ln : no])))
        if per_slice:
            sstream = model
        elif per_gop and not model._gop_emitted:
            # first recoded slice of the GOP carries the GOP's stream
            model._gop_emitted = True
            sstream = model
        elif per_gop:
            sstream = b""  # continuation marker: same GOP model
        else:
            sstream = None
        blocks.append((KIND_SLICE, rec.size, head, n_mbs, drop, tail, sstream, gaps))
        pos = rec.span_end or (rec.offset + rec.size)

    if pos < len(data):
        blocks.append((KIND_LITERAL, data[pos:]))
    # all parameter sets seen during the walk (incl. in-band) must ship in
    # the container — recoded slices may reference any of them
    return w.all_sps, w.all_pps, blocks, model


def serialize_container(scope, sps_list, pps_list, blocks, stream_model,
                        finisher=None, substream_bins=0):
    """Serialize scanned blocks into the AVTR container.  `finisher` maps a
    per-slice model object to its stream bytes (default: model.finish())."""
    per_slice = scope != SCOPE_STREAM
    finisher = finisher or (lambda m: m if isinstance(m, bytes) else m.finish())
    out = Writer()
    out.out += MAGIC
    out.u8(VERSION)
    out.u8(0)
    out.u16(scope)
    out.varint(substream_bins)
    out.varint(len(sps_list))
    for b in sps_list:
        out.blob(bytes(b))
    out.varint(len(pps_list))
    for b in pps_list:
        out.blob(bytes(b))
    for blk in blocks:
        if blk[0] == KIND_LITERAL:
            out.u8(KIND_LITERAL)
            out.blob(blk[1])
        else:
            _, nal_size, head, mb_count, drop, tail, sstream = blk[:7]
            gaps = blk[7] if len(blk) > 7 else []
            out.u8(KIND_SLICE)
            out.varint(nal_size)
            out.blob(head)
            out.varint(mb_count)
            out.varint(drop)
            out.blob(tail)
            out.varint(len(gaps))  # v6: TS segmentation (0 = contiguous)
            for seg_len, gap in gaps:
                out.varint(seg_len)
                out.blob(gap)
            if per_slice:
                out.blob(finisher(sstream))
    out.u8(KIND_END)
    out.blob(b"" if per_slice else stream_model.finish())
    return out.bytes()


def _compress_inner(data, verbose=False, scope=SCOPE_STREAM, slice_model_factory=None,
                    substream_bins=0):
    per_slice = scope != SCOPE_STREAM
    stats = {"slices": 0, "recoded": 0, "bins": 0}
    cabac_bill = {}
    sps_list, pps_list, blocks, model = _scan_blocks(
        data, scope, slice_model_factory, stats, cabac_bill,
        substream_bins=substream_bins,
    )
    result = serialize_container(
        scope, sps_list, pps_list, blocks, model, substream_bins=substream_bins
    )
    if verbose and not per_slice:
        import sys

        # the reference's dual ledger (Avrecode Bill vs CABAC Bill,
        # recode.cpp:642-668): per element class, recoded vs original bits
        classes = sorted(
            set(model.bill) | set(cabac_bill),
            key=lambda k: -cabac_bill.get(k, 0),
        )
        print(f"{'class':>10} {'cabac':>10} {'recode':>10} {'delta':>8}", file=sys.stderr)
        for k in classes:
            c, m = cabac_bill.get(k, 0), model.bill.get(k, 0)
            print(f"{str(k):>10} {c:>10} {m:>10} {m - c:>8}", file=sys.stderr)
        tc, tm = sum(cabac_bill.values()), sum(model.bill.values())
        print(f"{'TOTAL':>10} {tc:>10} {tm:>10} {tm - tc:>8}", file=sys.stderr)
        print(stats, file=sys.stderr)
    return result


def decompress(blob, _model_factory=None):
    """_model_factory(stream_bytes, substream_bins) -> decode-model object
    (default RecodeModel('decode', ...)): injection point for the device
    decompress pipeline (parallel/pipeline.device_decompress), which runs
    one pass with a probability-recording model and one with a model fed
    by the device-decoded bins."""
    mf = _model_factory or (
        lambda d, B: RecodeModel("decode", d, substream_bins=B))
    r = Reader(blob)
    if blob[:4] != MAGIC:
        raise ContainerError("bad magic (not an AVTR container)")
    r.pos = 4
    version = r.u8()
    if version != VERSION:
        raise ContainerError(f"unsupported container version {version}")
    r.u8()
    scope = r.u16()
    substream_bins = r.varint()
    per_slice = scope != SCOPE_STREAM
    sps_map, pps_map = {}, {}
    for _ in range(r.varint()):
        s = parse_sps(r.blob())
        sps_map.setdefault(s.sps_id, s)  # first definition wins (see stream.py)
    for _ in range(r.varint()):
        p = parse_pps(r.blob(), sps_map)
        pps_map.setdefault(p.pps_id, p)

    # first pass over blocks (model stream is at the end)
    blocks = []
    while True:
        kind = r.u8()
        if kind == KIND_END:
            break
        if kind == KIND_LITERAL:
            blocks.append((KIND_LITERAL, r.blob()))
        else:
            nal_size = r.varint()
            head = r.blob()
            mb_count = r.varint()
            drop = r.varint()
            tail = r.blob()
            gaps = [(r.varint(), r.blob()) for _ in range(r.varint())]
            sstream = r.blob() if per_slice else None
            blocks.append((KIND_SLICE, nal_size, head, mb_count, drop, tail,
                           sstream, gaps))
    model = None if per_slice else mf(r.blob(), substream_bins)

    out = bytearray()
    cur_pic = prev_pic = None
    slice_id = 0
    for blk in blocks:
        if blk[0] == KIND_LITERAL:
            out += blk[1]
            continue
        _, nal_size, head, mb_count, drop, tail, sstream, gaps = blk
        nal_type = head[0] & 0x1F
        nal_ref_idc = (head[0] >> 5) & 3
        hdr, sps, pps = parse_slice_header(
            head[1:], nal_type, nal_ref_idc, sps_map, pps_map
        )
        if scope == SCOPE_SLICE:
            smodel = mf(sstream, substream_bins)
        elif scope == SCOPE_GOP:
            if sstream:  # non-empty blob = GOP start: new model, wiped ring
                model = mf(sstream, substream_bins)
                cur_pic = prev_pic = None
            smodel = model
        else:
            smodel = model
        if smodel is None:
            raise ValueError("slice block without model stream")
        if hdr.first_mb_in_slice == 0 or cur_pic is None:
            prev_pic = cur_pic
            cur_pic = PicState(sps.pic_width_in_mbs,
                               mb_height(sps) >> int(hdr.field_pic))
        slice_id += 1
        if hdr.cavlc:
            # regenerate the bitstream from the modeled bits; the writer is
            # seeded with the partial byte's header bits, so its first byte
            # reproduces head's last byte (dropped from head below)
            pb = hdr.data_bit_offset & 7
            seed = (head[-1] >> (8 - pb)) if pb else 0
            coder = CavlcDecompressCoder(smodel, seed, pb)
            parser = CavlcSliceParser(
                sps, pps, hdr, cur_pic, prev_pic, coder, slice_id,
                isolate=(scope == SCOPE_SLICE),
            )
            parser.parse_slice_data(mb_count=mb_count)
            payload = bytes(coder.finish())
            head_eff = head[:-1] if pb else head
            full = (payload[:-drop] if drop else payload) + tail
            rbsp = head_eff[1:] + full
        else:
            idc = None if hdr.slice_type in (2, 4) else hdr.cabac_init_idc
            coder = DecompressCoder(hdr.slice_qp, idc, smodel)
            parser = SliceParser(
                sps, pps, hdr, cur_pic, prev_pic, coder, slice_id,
                isolate=(scope == SCOPE_SLICE),
            )
            parser.parse_slice_data(mb_count=mb_count)
            payload = coder.payload()
            # apply stored tail: drop re-encoded suffix bytes (the
            # x264-style final byte) and append the original suffix
            full = (payload[:-drop] if drop else payload) + tail
            rbsp = head[1:] + full
        nal = head[0:1] + escape_rbsp(rbsp)
        if len(nal) != nal_size:
            raise ContainerError("reconstructed NAL size mismatch")
        if gaps:  # TS: re-scatter the NAL into its original segments
            if sum(g[0] for g in gaps) > len(nal):
                raise ContainerError("segmented slice lengths exceed NAL")
            p2 = 0
            for seg_len, gap in gaps:
                out += nal[p2 : p2 + seg_len]
                out += gap
                p2 += seg_len
            out += nal[p2:]
        else:
            out += nal
    return bytes(out)


def roundtrip(data, verbose=False):
    """Reference's roundtrip oracle (recode.cpp:1601-1640): returns
    (ok, ratio_percent, compressed, decompressed)."""
    comp = compress(data, verbose=verbose)
    dec = decompress(comp)
    ok = dec == bytes(data)
    ratio = 100.0 * len(comp) / max(1, len(data))
    return ok, ratio, comp, dec
