"""The containers a run has to produce, from the input files alone.

A camera recording is a splice of GOP units (harness/inputs.py), and at gop
scope each GOP is a unit of its own: the model and the picture ring start
afresh at every IDR, so a GOP's slice blocks and its stream do not depend
on what came before it.  The recording's container is therefore the
units' containers joined: the parameter sets of all of them (each distinct
set once, in order of first appearance, as the codec's stream walker
collects them), their blocks in file order with a literal that ends one
unit and the literal that starts the next merged into one block (the codec
emits the bytes between two recoded slices as one literal), and the end
marker.  tests/test_reference_splice.py holds this to the codec run over
the whole spliced stream.

Compressing a 1080p GOP here takes minutes of one core, so each distinct
unit is compressed once per checkout: the container is kept under
build/benchmark_reference/, named by the input's SHA-256, the lane width
and a hash of the reference's own sources, and is computed again when any
of them changes.  Missing ones are computed in parallel, in processes of
their own, after the measured window."""

import concurrent.futures
import hashlib
import multiprocessing
import os
import pathlib

from .hostcodec import codec
from .hostcodec.utils.container import (
    KIND_END, KIND_LITERAL, KIND_SLICE, MAGIC, Reader, Writer)

HERE = pathlib.Path(__file__).resolve().parent
CACHE_DIR = HERE.parent.parent / "build" / "benchmark_reference"


def source_key():
    """A hash of the reference's sources: a cached container is valid only
    for the code that made it."""
    h = hashlib.sha256()
    for p in sorted(HERE.rglob("*.py")):
        h.update(p.relative_to(HERE).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def compress(data, substream_bins):
    """The reference container of one input at gop scope."""
    return codec.compress(data, scope="gop", substream_bins=substream_bins)


def _cache_path(data, substream_bins, key):
    name = f"{hashlib.sha256(data).hexdigest()}-{substream_bins}-{key}.avtr"
    return CACHE_DIR / name


def _compress_to(path, data, substream_bins):
    blob = compress(data, substream_bins)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.part")
    tmp.write_bytes(blob)
    os.replace(tmp, path)
    return len(blob)


def containers(inputs, substream_bins, workers=None):
    """{name: reference container} for {name: input bytes}, each from the
    cache or computed (in `workers` spawned processes, default one a core)."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    key = source_key()
    paths = {name: _cache_path(data, substream_bins, key)
             for name, data in inputs.items()}
    todo = [name for name, p in paths.items() if not p.exists()]
    if todo:
        n = min(len(todo), workers or len(os.sched_getaffinity(0)))
        ctx = multiprocessing.get_context("spawn")
        # largest first: the longest job starts first
        todo.sort(key=lambda name: -len(inputs[name]))
        with concurrent.futures.ProcessPoolExecutor(n, mp_context=ctx) as pool:
            futs = [pool.submit(_compress_to, paths[name], inputs[name],
                                substream_bins) for name in todo]
            for f in futs:
                f.result()
    return {name: p.read_bytes() for name, p in paths.items()}


def parse(blob):
    """A gop- or slice-scope container -> (header fields, sps list, pps
    list, blocks), each block (kind, its serialised bytes, the literal's
    payload or None)."""
    if bytes(blob[:4]) != MAGIC:
        raise ValueError("not a container")
    r = Reader(blob)
    r.pos = 4
    head = (r.u8(), r.u8(), r.u16(), r.varint())
    sps = [bytes(r.blob()) for _ in range(r.varint())]
    pps = [bytes(r.blob()) for _ in range(r.varint())]
    blocks = []
    while True:
        start = r.pos
        kind = r.u8()
        if kind == KIND_END:
            if r.blob():
                raise ValueError("a stream-scope container cannot be spliced")
            break
        if kind == KIND_LITERAL:
            payload = bytes(r.blob())
            blocks.append((kind, bytes(blob[start:r.pos]), payload))
            continue
        if kind != KIND_SLICE:
            raise ValueError(f"bad block kind {kind}")
        r.varint(), r.blob(), r.varint(), r.varint(), r.blob()
        for _ in range(r.varint()):
            r.varint(), r.blob()
        r.blob()
        blocks.append((kind, bytes(blob[start:r.pos]), None))
    if r.pos != len(blob):
        raise ValueError("bytes after the end marker")
    return head, sps, pps, blocks


def splice(unit_containers):
    """The container of the units' streams joined in order, from each
    unit's own container (see the module docstring)."""
    parsed = [parse(c) for c in unit_containers]
    heads = {p[0] for p in parsed}
    if len(heads) != 1:
        raise ValueError(f"units of different container headers: {heads}")
    version, flags, scope, substream_bins = heads.pop()
    sps, pps, blocks = [], [], []
    for _, u_sps, u_pps, u_blocks in parsed:
        sps += [b for b in u_sps if b not in sps]
        pps += [b for b in u_pps if b not in pps]
        for kind, raw, payload in u_blocks:
            if kind == KIND_LITERAL and blocks and blocks[-1][0] == KIND_LITERAL:
                blocks[-1] = (KIND_LITERAL, None, blocks[-1][2] + payload)
            else:
                blocks.append((kind, raw, payload))
    out = Writer()
    out.out += MAGIC
    out.u8(version)
    out.u8(flags)
    out.u16(scope)
    out.varint(substream_bins)
    for sets in (sps, pps):
        out.varint(len(sets))
        for b in sets:
            out.blob(b)
    for kind, raw, payload in blocks:
        if kind == KIND_LITERAL:
            out.u8(KIND_LITERAL)
            out.blob(payload)
        else:
            out.out += raw
    out.u8(KIND_END)
    out.blob(b"")
    return out.bytes()
