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
and data/cavlc_ipp.mkv for the CAVLC check.  The compress checks must launch
lane_encode_streams (the fused kernel of the main path); the lane decoder
check codes its lanes with lane_encode and the host finalize.  Exits
non-zero when a check fails or there is no card.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)


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


def main(argv):
    import torch

    from avrecode_tpu_torch import codec
    from avrecode_tpu_torch.graft_entry import dryrun_multichip
    from avrecode_tpu_torch.host import native
    from avrecode_tpu_torch.ops.est_coder import est_encode
    from avrecode_tpu_torch.ops.lane_coder import (
        lane_encode, lane_encode_streams)
    from avrecode_tpu_torch.ops.lane_decoder import lane_decode
    from avrecode_tpu_torch.parallel.pipeline import (
        device_compress, device_decompress, make_mesh)

    out_path = os.path.join(ROOT, "GPU_VERIFY.json")
    if argv[:1] == ["--out"]:
        out_path, argv = argv[1], argv[2:]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: gpu_verify.py needs an NVIDIA GPU")
    clip = argv[0] if argv else os.path.join(ROOT, "data", "mbaff_b.mkv")
    small = argv[1] if argv[1:] else os.path.join(ROOT, "data", "rt_ctr.mkv")
    data, sdata = _read(clip), _read(small)
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
        "clip": os.path.basename(clip),
        "clip_bytes": len(data),
        "small_clip": os.path.basename(small),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "checks": {},
    }

    def check(name, fn, kernels):
        """Record fn()'s verdict; ok also needs a launch of every kernel."""
        before = [k.launches for k in kernels]
        t0 = time.time()
        try:
            ok = bool(fn())
        except Exception as e:  # record, don't hide
            out["checks"][name] = {"ok": False, "error": repr(e)[:200]}
            return
        launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
        out["checks"][name] = {
            "ok": ok and all(launches.values()),
            "s": round(time.time() - t0, 2),
            "launches": launches,
        }

    check("lane_coder_gop_byte_identical", lambda: (
        device_compress(data, scope="gop", substream_bins=4096)
        == codec.compress(data, scope="gop", substream_bins=4096)),
        [lane_encode_streams])
    check("est_kernel_slice_byte_identical", lambda: (
        device_compress(sdata, scope="slice", substream_bins=0)
        == native.compress(sdata, scope="slice")), [est_encode])
    check("device_container_roundtrips_both_decoders", lambda: (
        (lambda c: codec.decompress(c) == data and
         native.decompress(c) == data)(
            device_compress(data, scope="gop", substream_bins=4096))),
        [lane_encode_streams])
    check("lane_decoder_inverts_on_chip", lambda: _lane_decode_check(data),
          [lane_encode, lane_decode])
    check("device_decompress_end_to_end", lambda: device_decompress(
        codec.compress(sdata, scope="gop", substream_bins=4096)) == sdata,
        [lane_decode])
    # several shards on the card, and several ranks that share it (the
    # port's stand-in for the JAX package's multi-chip dry-run records)
    mesh = make_mesh(4, device="cuda:0")
    check("mesh_lane_coder_byte_identical", lambda: (
        device_compress(data, mesh=mesh, scope="gop", substream_bins=4096)
        == codec.compress(data, scope="gop", substream_bins=4096)),
        [lane_encode_streams])
    check("mesh_est_kernel_byte_identical", lambda: (
        device_compress(sdata, mesh=mesh, scope="slice", substream_bins=0)
        == native.compress(sdata, scope="slice")), [est_encode])

    def dryrun():
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

    check("dryrun_multichip_4_ranks", dryrun, [])
    # CAVLC streams ride the same device pipelines
    cdata = _read(os.path.join(ROOT, "data", "cavlc_ipp.mkv"))
    check("cavlc_lane_coder_byte_identical", lambda: (
        device_compress(cdata, scope="gop", substream_bins=4096)
        == codec.compress(cdata, scope="gop", substream_bins=4096)
        and native.decompress(
            device_compress(cdata, scope="gop", substream_bins=4096))
        == cdata), [lane_encode_streams])
    out["all_ok"] = all(c["ok"] for c in out["checks"].values())
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
