#!/usr/bin/env python
"""Byte-identity verification of the PyTorch + CUDA port on a real GPU,
recorded as an artifact.

Runs the port's device paths (avrecode_tpu_torch) on the card, compares
them byte for byte with the port's host codec, and writes GPU_VERIFY.json,
so that on-card byte-identity is a pinned, reproducible record.  The checks
are those of tools/tpu_verify.py, then a meshed device_compress (both
paths) and dryrun_multichip(4) with the backend that ran; each one also
requires that the CUDA kernel it is about was launched.

Usage: python tools/gpu_verify.py [--out PATH] [clip [small_clip]]

The default clips are the pinned ones (data/mbaff_b.mkv, data/rt_ctr.mkv),
and data/cavlc_ipp.mkv for the CAVLC check.  Each check names the kernels
whose launches it counts, in CHECKS; its record keeps each one's launches.
The compress checks accept either fused launcher of the main path,
lane_encode_streams_idx (the 12-bit index upload, which native traces
take) or lane_encode_streams (uint16 p1), and pass when the two launched
at least once between them; off_image_lanes_take_u16 sends lanes of real
traces with every p1 moved off the squash image through
lane_streams_device_compact and requires lane_encode_streams and no index
launch.  The est checks count est_encode (the single-device one also
est_unpack, which unpacks native traces' records), the decoder checks
lane_decode (and lane_encode, which codes the lanes that
lane_decoder_inverts_on_chip decodes).  Exits non-zero when a check fails or there is no card.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

B = 4096  # substream_bins of the lane checks
CLIP, SMALL, CAVLC = "mbaff_b.mkv", "rt_ctr.mkv", "cavlc_ipp.mkv"
FUSED = ("lane_encode_streams_idx", "lane_encode_streams")
# The checks, in the order they run: name -> (the clip it codes, the kernels
# whose launches it records, the rule on those launches).  Rules:
#   "each"  every kernel named launched;
#   "any"   the launches of the kernels named, summed, grew: the compress
#           checks accept either fused launcher, since pack_lanes chooses the
#           upload form (avrecode_tpu_torch/bench.py counts them alike);
#   "first" the first kernel named launched and the others did not.
CHECKS = {
    "lane_coder_gop_byte_identical": (CLIP, FUSED, "any"),
    "est_kernel_slice_byte_identical": (SMALL, ("est_encode", "est_unpack"),
                                        "each"),
    "device_container_roundtrips_both_decoders": (CLIP, FUSED, "any"),
    "lane_decoder_inverts_on_chip": (CLIP, ("lane_encode", "lane_decode"),
                                     "each"),
    "device_decompress_end_to_end": (SMALL, ("lane_decode",), "each"),
    "mesh_lane_coder_byte_identical": (CLIP, FUSED, "any"),
    "mesh_est_kernel_byte_identical": (SMALL, ("est_encode",), "each"),
    "dryrun_multichip_4_ranks": (None, (), "each"),
    "cavlc_lane_coder_byte_identical": (CAVLC, FUSED, "any"),
    "off_image_lanes_take_u16": (CLIP, FUSED[::-1], "first"),
}


def launches_ok(rule, launches):
    """Does `launches` (kernel name -> launches in the check, in CHECKS'
    order) meet `rule`?"""
    n = list(launches.values())
    if rule == "each":
        return all(n)
    if rule == "any":
        return sum(n) > 0
    if rule == "first":
        return n[0] > 0 and not any(n[1:])
    raise ValueError(f"unknown rule {rule!r}")


def _kernel(name):
    """The wrapper that counts `name`'s launches."""
    from avrecode_tpu_torch.ops import est_coder, lane_coder, lane_decoder

    for mod in (lane_coder, est_coder, lane_decoder):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _lane_decode_check(data):
    """Lanes of the clip's real traces, encoded by the lane kernel and the
    host finalize, decode on the card to the bits that went in."""
    import numpy as np

    from avrecode_tpu_torch.ops import lane_coder as tlc
    from avrecode_tpu_torch.ops.lane_decoder import decode_streams_lanes
    from avrecode_tpu_torch.parallel.pipeline import extract_traces

    *_, traces, _ = extract_traces(data, scope="gop")
    traces = [t for t in traces if len(t)]
    bitp1, lens, _ = tlc.split_lanes(traces, 2048)
    prob = tlc.from_numpy_problem(*tlc.pack_compact(bitp1, lens, pad_lanes=1),
                                  "cuda")
    raw = (t.cpu().numpy()[: len(lens)] for t in tlc.lane_encode(*prob))
    streams = tlc.finalize_lanes(*raw, lens)
    bits = decode_streams_lanes(streams, bitp1 & 0xFFFF, lens).cpu().numpy()
    want = (bitp1 >> 16) & 1
    mask = np.arange(bitp1.shape[1])[None, :] < lens[:, None]
    return np.array_equal(bits, want * mask)


def off_image_lanes(data):
    """Lanes of the clip's real traces (gop scope, B bins), every valid p1
    moved to the nearest value off the squash table's image: a lane problem
    (p1 uint16, bitw, lens) that keeps the u16 form."""
    import numpy as np

    from avrecode_tpu_torch.host import native
    from avrecode_tpu_torch.ops import lane_coder as tlc

    traces = native.extract(data, "gop", want_slots=False)[3]
    p1u16, bitw, lens, _ = tlc.split_lanes_recs(traces, B)
    in_image = tlc._squash_tables()[2]
    off = np.flatnonzero(~in_image)  # 1..21, gaps of the image, 65515..
    v = np.arange(1 << 16)
    i = np.clip(np.searchsorted(off, v), 1, len(off) - 1)
    lo, hi = off[i - 1], off[i]
    nearest = np.where(v - lo <= hi - v, lo, hi).astype(np.uint16)
    live = np.arange(p1u16.shape[1])[None, :] < lens[:, None]
    return np.where(live, nearest[p1u16], p1u16), bitw, lens


def off_image_check(data, device):
    """off_image_lanes through the squash-image rule (choose_form) and
    lane_streams_device_compact: the u16 form kept, and streams equal to the
    host finalize of the plain encoder's tokens on the same lanes."""
    import numpy as np
    import torch

    from avrecode_tpu_torch.ops import lane_coder as tlc

    p1u16, bitw, lens = off_image_lanes(data)
    chosen = tlc.choose_form(p1u16, lens)
    got = tlc.lane_streams_device_compact(chosen, bitw, lens, device)
    prob = tlc.from_numpy_problem(p1u16, bitw, lens, torch.device("cpu"))
    ref = tlc.finalize_lanes(*(t.numpy() for t in tlc.lane_encode_plain(*prob)),
                             lens)
    return chosen.dtype == np.uint16 and got == ref


def main(argv):
    import torch

    from avrecode_tpu_torch import codec
    from avrecode_tpu_torch.graft_entry import dryrun_multichip
    from avrecode_tpu_torch.host import native
    from avrecode_tpu_torch.parallel.pipeline import (
        device_compress, device_decompress, make_mesh)

    out_path = os.path.join(ROOT, "GPU_VERIFY.json")
    if argv[:1] == ["--out"]:
        out_path, argv = argv[1], argv[2:]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: gpu_verify.py needs an NVIDIA GPU")
    paths = {name: os.path.join(ROOT, "data", name)
             for name in (CLIP, SMALL, CAVLC)}
    for name, path in zip((CLIP, SMALL), argv):
        paths[name] = path
    datas = {name: _read(path) for name, path in paths.items()}
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    out = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "clip": os.path.basename(paths[CLIP]),
        "clip_bytes": len(datas[CLIP]),
        "small_clip": os.path.basename(paths[SMALL]),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "checks": {},
    }

    def check(name, fn):
        """Record fn(clip bytes)'s verdict; ok also needs the launches that
        the check's rule asks for (CHECKS)."""
        clip, names, rule = CHECKS[name]
        kernels = [_kernel(k) for k in names]
        before = [k.launches for k in kernels]
        t0 = time.time()
        try:
            ok = bool(fn(datas.get(clip)))
        except Exception as e:  # record, don't hide
            out["checks"][name] = {"ok": False, "error": repr(e)[:200]}
            return
        launches = {n: k.launches - b
                    for n, k, b in zip(names, kernels, before)}
        out["checks"][name] = {
            "ok": ok and launches_ok(rule, launches),
            "s": round(time.time() - t0, 2),
            "rule": rule,
            "launches": launches,
        }

    def lane_compress(d, **kw):
        return device_compress(d, scope="gop", substream_bins=B, **kw)

    def roundtrips(d):
        c = lane_compress(d)
        return codec.decompress(c) == d and native.decompress(c) == d

    # several shards on the card, and several ranks that share it (the
    # port's stand-in for the JAX package's multi-chip dry-run records)
    mesh = make_mesh(4, device="cuda:0")

    def dryrun(_):
        reports = dryrun_multichip(4)
        out["dryrun_multichip"] = {
            "ranks": len(reports),
            "backend": reports[0]["backend"],
            "grid": list(reports[0]["result"]["grid"]),
            "devices": [r["result"]["device"] for r in reports],
            "lane_encode_launches": [r["result"]["launches"] for r in reports],
            "total_bytes": reports[0]["result"]["total"],
            "offsets": [r["result"]["offset"] for r in reports],
        }
        return all(r["result"]["launches"] >= 1 for r in reports)

    fns = {
        "lane_coder_gop_byte_identical": lambda d: (
            lane_compress(d)
            == codec.compress(d, scope="gop", substream_bins=B)),
        "est_kernel_slice_byte_identical": lambda d: (
            device_compress(d, scope="slice", substream_bins=0)
            == native.compress(d, scope="slice")),
        "device_container_roundtrips_both_decoders": roundtrips,
        "lane_decoder_inverts_on_chip": _lane_decode_check,
        "device_decompress_end_to_end": lambda d: device_decompress(
            codec.compress(d, scope="gop", substream_bins=B)) == d,
        "mesh_lane_coder_byte_identical": lambda d: (
            lane_compress(d, mesh=mesh)
            == codec.compress(d, scope="gop", substream_bins=B)),
        "mesh_est_kernel_byte_identical": lambda d: (
            device_compress(d, mesh=mesh, scope="slice", substream_bins=0)
            == native.compress(d, scope="slice")),
        "dryrun_multichip_4_ranks": dryrun,
        # CAVLC streams ride the same device pipelines
        "cavlc_lane_coder_byte_identical": lambda d: (
            lane_compress(d) == codec.compress(d, scope="gop",
                                               substream_bins=B)
            and roundtrips(d)),
        "off_image_lanes_take_u16": lambda d: off_image_check(d, "cuda"),
    }
    assert list(fns) == list(CHECKS)
    for name, fn in fns.items():
        check(name, fn)
    out["all_ok"] = all(c["ok"] for c in out["checks"].values())
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
