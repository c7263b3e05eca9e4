"""Recoded container format (successor of recode.proto / SURVEY.md C13).

A compact self-describing binary format, no protobuf dependency:

  header:  magic 'AVTR' | u8 version | u8 flags | u16 model_scope
           varint n_sps, each: varint len + bytes (raw SPS NAL payloads)
           varint n_pps, each: varint len + bytes
  blocks:  u8 kind, then
           kind 0 LITERAL: varint len, bytes
           kind 1 SLICE:   varint nal_size, varint head_len, head bytes
                           (unescaped: nal hdr byte + header RBSP up to the
                           CABAC start), varint mb_count, varint tail_len,
                           tail bytes (original payload suffix incl. the
                           x264-style final byte — generalizes last_byte /
                           length_parity, recode.proto:16-17)
           kind 2 END
  stream:  varint len, recoded model stream bytes (single stream for
           model_scope=0 'stream'; per-shard streams in parallel scopes)

The SLICE block carries no entropy payload of its own; all recoded bins from
all slices share the model stream(s), like the reference's single adaptive
model over the whole file (model scope is recorded so decompression can
re-parallelize identically — SURVEY.md §2 'model scope' note).
"""

MAGIC = b"AVTR"
VERSION = 12  # v12: CAVLC slice blocks (bit-modeled; model v10 otherwise)
# become multi-stream envelopes when it is nonzero (see h264_model.py)


class ContainerError(ValueError):
    """Malformed .avtr container (bad magic, truncated field, oversized
    varint).  Raised instead of bare asserts so corrupt inputs fail with a
    typed, catchable error even under ``python -O`` (ADVICE r1)."""

KIND_LITERAL = 0
KIND_SLICE = 1
KIND_END = 2

SCOPE_STREAM = 0  # one adaptive model + one range stream for the whole file
SCOPE_SLICE = 1  # independent model per slice (parallel decode)
SCOPE_GOP = 2  # model reset at IDR boundaries (GOP-parallel decode)


def put_varint(out, v):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


class Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def u8(self):
        if self.pos >= len(self.data):
            raise ContainerError("truncated container: u8 past EOF")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u16(self):
        if self.pos + 2 > len(self.data):
            raise ContainerError("truncated container: u16 past EOF")
        v = int.from_bytes(self.data[self.pos : self.pos + 2], "little")
        self.pos += 2
        return v

    def varint(self):
        v = 0
        shift = 0
        while True:
            if self.pos >= len(self.data):
                raise ContainerError("truncated container: varint past EOF")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ContainerError("oversized varint (>9 bytes)")

    def blob(self):
        n = self.varint()
        if self.pos + n > len(self.data):
            raise ContainerError("truncated container: blob past EOF")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b


class Writer:
    def __init__(self):
        self.out = bytearray()

    def u8(self, v):
        self.out.append(v)

    def u16(self, v):
        self.out += v.to_bytes(2, "little")

    def varint(self, v):
        put_varint(self.out, v)

    def blob(self, b):
        self.varint(len(b))
        self.out += b

    def bytes(self):
        return bytes(self.out)


def scan_gop_groups(blob):
    """Structural container scan (no stream decode): returns
    (header_end, [(start, end), ...]) where the ranges partition the block
    region of a gop-scope container into GOP groups — each starting at a
    GOP-start slice block (non-empty stream slot), literals attached to the
    preceding group.  Returns None for non-gop scopes.  The decomposition
    unit shared by multi-host decode (parallel/multihost.py) and streaming
    IO (utils/streamio.py)."""
    if bytes(blob[:4]) != MAGIC:
        raise ContainerError("bad magic")
    r = Reader(blob)
    r.pos = 4
    r.u8(), r.u8()
    scope = r.u16()
    r.varint()  # substream_bins
    for _ in range(r.varint()):
        r.blob()
    for _ in range(r.varint()):
        r.blob()
    header_end = r.pos
    if scope != SCOPE_GOP:
        return None
    blocks = []  # (offset, is_gop_start)
    while True:
        off = r.pos
        kind = r.u8()
        if kind == KIND_END:
            end_off = off
            break
        if kind == KIND_LITERAL:
            r.blob()
            blocks.append((off, False))
            continue
        if kind != KIND_SLICE:
            raise ContainerError("bad block kind")
        r.varint(), r.blob(), r.varint(), r.varint(), r.blob()
        for _ in range(r.varint()):  # v6 segmentation entries
            r.varint(), r.blob()
        sstream = r.blob()
        blocks.append((off, len(sstream) > 0))
    if not blocks:
        return header_end, [(header_end, end_off)]
    starts = [off for off, g in blocks if g]
    if not starts:  # literal-only container: one group
        return header_end, [(blocks[0][0], end_off)]
    groups = []
    first = blocks[0][0]
    for i, s in enumerate(starts):
        lo = first if i == 0 else s
        hi = starts[i + 1] if i + 1 < len(starts) else end_off
        groups.append((lo, hi))
    return header_end, groups
