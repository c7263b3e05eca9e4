"""Benchmark driver of the port: corpus recode on the device path (native
trace extraction + the lane-parallel CUDA coder), with the native host path
as the comparison baseline, printing ONE JSON line to stdout:

  {"metric": ..., "value": <compress MB/s of the fastest clean path>,
   "unit": "MB/s", "vs_baseline": <space saving % / 5% target>, ...detail...}

    python3 -m avrecode_tpu_torch.bench                 # on the card
    python3 -m avrecode_tpu_torch.bench --device cpu    # plain torch (tests)
    python3 -m avrecode_tpu_torch.bench --device-corpus PATH...   # inner run

The counterpart of the JAX package's bench.py, with its corpus, names and
JSON fields, so that the two lines can be read side by side.  Where it
differs:

  - the device section runs on the card unless --device cpu is given, and
    is never skipped: a device section that raises, prints no result line
    or runs past its budget gives a line that says which and a non-zero
    exit, as does any roundtrip failure, host or device (either zeroes the
    headline); there is no host-only fallback;
  - the host library and the kernels are built before the first timed
    pass, and there is no shape warm-up (nothing compiles per shape);
  - all three passes run, each reported;
  - the line names the card (`device_name`, `power_limit`, from
    nvidia-smi) and counts each pass's kernel launches and overflow groups,
    and its lane pack (`pack_s`, summed over the extraction workers) and
    rows copied into the groups (`copy_s`, the main thread), host clock.

The x264 clips are made with tools/genvideo (a C program against the
system's libavcodec + libx264) where missing; the five conformance streams
are pinned files under data/.  A clip that cannot be made, or a missing
pinned stream, raises with the list of what is missing: the corpus never
shrinks silently.
"""

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

import torch

from . import resolve_device
from .host import native
from .ops import _build, lane_coder
from .parallel import pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
GEN = os.path.join(ROOT, "tools", "genvideo")

CORPUS = [
    # name, W, H, frames, fps, gop, bframes, crf, seed, slices[, extra[, fmt]]
    ("bench_720p_ipp.mp4", 1280, 720, 48, 30, 24, 0, 23, 101, 1),
    ("bench_720p_b.mp4", 1280, 720, 48, 30, 24, 2, 23, 202, 1),
    ("bench_1080p_ms.mp4", 1920, 1080, 30, 30, 30, 2, 26, 303, 4),
    ("bench_480p.mp4", 854, 480, 60, 30, 30, 1, 22, 404, 1),
    # long multi-GOP stream
    ("bench_long_720p.mp4", 1280, 720, 240, 30, 24, 2, 23, 7, 1),
    # production-scale entries: they dominate the corpus total
    ("bench_1080p_long.mp4", 1920, 1080, 360, 30, 30, 2, 24, 909, 1),
    ("bench_4k.mp4", 3840, 2160, 48, 30, 24, 1, 26, 808, 4),
    ("bench_1080p_hq.mp4", 1920, 1080, 240, 30, 30, 2, 18, 505, 1),
    # hostile syntax: custom quant matrices + 16 refs, MBAFF interlace,
    # intra-refresh + 8 slices, 10-bit 4:2:2 MBAFF
    ("bench_cqm_720p.mp4", 1280, 720, 48, 30, 24, 2, 23, 707, 1,
     "cqm=jvt:ref=16"),
    ("bench_mbaff_720p.mp4", 1280, 720, 36, 30, 18, 2, 24, 606, 1,
     "interlaced=1"),
    ("bench_ir_1080p.mp4", 1920, 1080, 40, 30, 20, 0, 24, 808, 8,
     "intra-refresh=1"),
    ("bench_422mbaff10.mp4", 960, 540, 30, 30, 15, 2, 25, 909, 1,
     "interlaced=1", "x2210"),
    # CAVLC (baseline profile / --no-cabac streams)
    ("bench_cavlc_720p.mp4", 1280, 720, 48, 30, 24, 0, 23, 111, 1,
     "cabac=0"),
    ("bench_cavlc_b_480p.mp4", 854, 480, 60, 30, 30, 2, 24, 222, 1,
     "cabac=0:ref=4"),
    # x264 lossless (High 4:4:4 Predictive + CAVLC)
    ("bench_cavlc_ll480.mp4", 854, 480, 24, 30, 12, 0, 0, 333, 1,
     "cabac=0:qp=0", "x444"),
]

# per-file generator environment (genvideo content knobs)
CORPUS_ENV = {
    "bench_mbaff_720p.mp4": {"AVT_COMB": "1", "AVT_NOISE": "12"},
}

# hand-authored conformance streams (I_PCM, PAFF fields, monochrome,
# separate colour planes, SP/SI), pinned under data/; the commands are
# how they were made (the generators import the JAX package's host layer,
# so the port's bench only reads the files)
CONFORMANCE = [
    ("pcm_big.264", ["tools/gen_pcm.py", "data/pcm_big.264", "8x6", "4"]),
    ("paff.264", ["tools/gen_paff.py", "data/paff.264"]),
    ("mono.264", ["tools/gen_mono.py", "data/mono.264", "16x12", "6"]),
    ("sep.264", ["tools/gen_sep.py", "data/sep.264", "8x6", "4"]),
    ("spsi.264", ["tools/gen_sp.py", "data/spsi.264", "16x12"]),
]

CORPUS_B = 16384  # lane width of the batched corpus
PASSES = 3  # timed passes of the device corpus, every one reported
BUDGET_S = 2400  # the device section's time limit


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _genvideo():
    """tools/genvideo, built with gcc where it is missing."""
    if not os.path.exists(GEN):
        subprocess.run(
            ["gcc", "-O2", "-o", GEN, GEN + ".c", "-lavformat", "-lavcodec",
             "-lavutil", "-lm"],
            check=True, capture_output=True, text=True,
        )
    return GEN


def ensure_corpus():
    """The corpus's paths (the x264 clips, then the conformance streams);
    makes missing clips with tools/genvideo.  Raises RuntimeError naming
    every file that is missing and why."""
    os.makedirs(DATA, exist_ok=True)
    failed = {}  # why -> names
    todo = [(name, args) for name, *args in CORPUS
            if not os.path.exists(os.path.join(DATA, name))]
    if todo:
        try:
            gen = _genvideo()
        except subprocess.CalledProcessError as e:
            gen, why = None, f"building tools/genvideo failed: {e.stderr[-300:]}"
        except OSError as e:
            gen, why = None, f"building tools/genvideo failed: {e}"
        for name, args in todo:
            if gen is None:
                failed.setdefault(why, []).append(name)
                continue
            p = os.path.join(DATA, name)
            tmp = os.path.join(DATA, ".partial." + name)  # keeps the suffix
            env = {**os.environ, **CORPUS_ENV.get(name, {})}
            r = subprocess.run([gen, tmp, *map(str, args)], capture_output=True,
                               text=True, env=env)
            if r.returncode == 0 and os.path.exists(tmp):
                os.replace(tmp, p)
            else:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                why = (f"tools/genvideo exited {r.returncode}: "
                       f"{r.stderr.strip()[-300:]}")
                failed.setdefault(why, []).append(name)
    for name, _ in CONFORMANCE:
        if not os.path.exists(os.path.join(DATA, name)):
            failed.setdefault("pinned conformance streams missing from data/",
                              []).append(name)
    if failed:
        raise RuntimeError(
            f"bench corpus incomplete, {sum(map(len, failed.values()))} files "
            "missing: " + "; ".join(f"{', '.join(names)} ({why})"
                                    for why, names in failed.items()))
    return [os.path.join(DATA, name) for name, *_ in CORPUS + CONFORMANCE]


def ensure_native():
    """Builds the port's host library; raises where it cannot be loaded
    (the Python extractor would otherwise be timed)."""
    native.build()
    if not native.available():
        raise RuntimeError("the port's libavtpu.so is not available (make "
                           "and g++ are needed)")


def card(dev):
    """(device_name, power_limit) of a CUDA device as nvidia-smi's
    `--query-gpu=name,power.limit` gives them; (None, None) off the card."""
    if dev.type != "cuda":
        return None, None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    r = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = (s.strip() for s in r.stdout.strip().rsplit(",", 1))
    return name, limit


def containers_digest(comps):
    """One hash over a pass's containers, each with its length."""
    h = hashlib.sha256()
    for c in comps:
        h.update(len(c).to_bytes(8, "little"))
        h.update(c)
    return h.hexdigest()


def device_corpus(paths, device=None, substream_bins=CORPUS_B):
    """The device section (runs inside the subprocess): PASSES timed passes
    of device_compress_corpus over `paths`; every container of the last
    pass decompressed by the native decoder and compared with its file,
    and every pass's containers held to the last pass's by a hash taken
    after the pass's clock stops; the stage split on the largest file.
    Raises when a CUDA pass did not launch the fused lane kernel once a
    dispatch group, or when a pass's containers differ from the last
    pass's."""
    dev = resolve_device(device)
    ensure_native()
    if dev.type == "cuda":
        _build.load()
    fused = (lane_coder.lane_encode_streams_idx, lane_coder.lane_encode_streams)
    pass_s, launches, overflows, digests = [], [], [], []
    pack_s, copy_s = [], []
    for i in range(PASSES):
        stats = {}
        n0 = sum(k.launches for k in fused)
        o0 = lane_coder.lane_collect.overflows
        t0 = time.perf_counter()
        comps = pipeline.device_compress_corpus(
            paths, scope="gop", substream_bins=substream_bins, device=dev,
            stats=stats)
        pass_s.append(time.perf_counter() - t0)
        digests.append(containers_digest(comps))
        launches.append(sum(k.launches for k in fused) - n0)
        overflows.append(lane_coder.lane_collect.overflows - o0)
        pack_s.append(stats["pack_s"])
        copy_s.append(stats["copy_s"])
        log(f"device corpus pass {i + 1}: {pass_s[-1]:.3f} s, "
            f"{stats['dispatches']} dispatches, {launches[-1]} fused kernel "
            f"launches, lane_collect.overflows {overflows[-1]}; lane pack "
            f"{pack_s[-1]:.3f} s summed over the extraction workers, rows "
            f"copied into the groups {copy_s[-1]:.3f} s on the main thread")
        if dev.type == "cuda" and launches[-1] < stats["dispatches"]:
            raise RuntimeError(
                f"pass {i + 1}: {launches[-1]} fused lane kernel launches for "
                f"{stats['dispatches']} dispatch groups")
    differ = [i + 1 for i, d in enumerate(digests) if d != digests[-1]]
    if differ:
        raise RuntimeError(
            f"pass {', '.join(map(str, differ))} of {PASSES}: containers "
            "differ from the last pass's")
    files = []
    total_in = total_out = failures = 0
    for p, comp in zip(paths, comps):
        data = open(p, "rb").read()
        ok = native.decompress(comp, 0) == data
        failures += 0 if ok else 1
        total_in += len(data)
        total_out += len(comp)
        files.append({
            "file": os.path.basename(p),
            "mb": round(len(data) / 1e6, 3),
            "ratio_pct": round(100 * len(comp) / len(data), 2),
            "roundtrip": "OK" if ok else "FAIL",
        })
        log("device:", files[-1])
    del comps
    split = stage_split(max(paths, key=os.path.getsize), dev, substream_bins)
    name, limit = card(dev)
    return {
        "backend": dev.type,
        "kernel": "cuda-lane" if dev.type == "cuda" else "torch-plain-lane",
        "device_name": name,
        "power_limit": limit,
        "substream_bins": substream_bins,
        "files": files,
        "compress_mb_s": round(total_in / 1e6 / max(min(pass_s), 1e-9), 3),
        "pass_s": [round(s, 3) for s in pass_s],
        "pass_mb_s": sorted((round(total_in / 1e6 / max(s, 1e-9), 3)
                             for s in pass_s), reverse=True),
        "ratio_pct": round(100.0 * total_out / max(total_in, 1), 2),
        "roundtrip_failures": failures,
        "dispatches": stats["dispatches"],
        "corpus_bins": stats["bins"],
        "kernel_launches": launches,
        "overflows": overflows,
        "pack_s": [round(s, 3) for s in pack_s],
        "copy_s": [round(s, 3) for s in copy_s],
        "stage_split_480p": split,
        "max_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        "total_in": total_in,
        "total_out": total_out,
    }


def stage_split(path, dev, substream_bins):
    """Host extraction, then the device entropy stage, on one file, on the
    host clock with the card synchronised before each reading."""
    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    data = open(path, "rb").read()
    t0 = now()
    _, _, _, traces, stats = pipeline.extract_traces(data, scope="gop")
    t_parse = now() - t0
    if not stats["native"]:
        raise RuntimeError(f"{os.path.basename(path)}: the native extractor "
                           "did not run")
    n_bins = int(sum(len(t) for t in traces))
    t0 = now()
    lane_coder.encode_traces_lanes(traces, substream_bins, device=dev)
    t_dev = now() - t0
    return {
        "file": os.path.basename(path),
        "host_extract_s": round(t_parse, 4),
        "device_entropy_s": round(t_dev, 4),
        "bins": n_bins,
        "device_bins_per_s": round(n_bins / max(t_dev, 1e-9)),
    }


def bench_device(paths, device, budget_s=BUDGET_S):
    """Runs the device section in a subprocess under a time limit; returns
    its result line, or {"error": why} where it raised, printed no result
    line or ran out of time."""
    cmd = [sys.executable, "-m", "avrecode_tpu_torch.bench", "--device",
           str(device), "--device-corpus", *paths]
    try:
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=budget_s)
    except subprocess.TimeoutExpired:
        return {"error": f"device section timed out: past its {budget_s} s "
                         "budget"}
    sys.stderr.write(r.stderr[-2000:])
    for line in reversed(r.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    if r.returncode:
        tail = r.stderr.strip().splitlines()[-1:] or [""]
        return {"error": f"device section raised (exit {r.returncode}): "
                         f"{tail[0][-300:]}"}
    return {"error": "device section printed no result line (exit 0)"}


def host_corpus(paths):
    """The host baseline: native compress (gop scope, all cores) and
    decompress of every file."""
    files = []
    total_in = total_out = failures = 0
    total_ct = total_dt = 0.0
    for p in paths:
        data = open(p, "rb").read()
        t0 = time.perf_counter()
        comp = native.compress(data, "gop", 0)
        t1 = time.perf_counter()
        dec = native.decompress(comp, 0)
        t2 = time.perf_counter()
        ok = dec == data
        failures += 0 if ok else 1
        total_in += len(data)
        total_out += len(comp)
        total_ct += t1 - t0
        total_dt += t2 - t1
        files.append({
            "file": os.path.basename(p),
            "mb": round(len(data) / 1e6, 3),
            "ratio_pct": round(100 * len(comp) / len(data), 2),
            "compress_mb_s": round(len(data) / 1e6 / max(t1 - t0, 1e-9), 3),
            "decompress_mb_s": round(len(data) / 1e6 / max(t2 - t1, 1e-9), 3),
            "roundtrip": "OK" if ok else "FAIL",
        })
        log(files[-1])
    return {"files": files, "failures": failures, "total_in": total_in,
            "total_out": total_out, "compress_s": total_ct,
            "decompress_s": total_dt}


def headline(host, dev):
    """The result line: the fastest clean path's speed (bench.py's rule),
    zeroed, with the reason in the line, by any roundtrip failure or a
    device section that did not give its result."""
    total_in = host["total_in"]
    host_mb_s = total_in / 1e6 / max(host["compress_s"], 1e-9)
    host_ratio = 100.0 * host["total_out"] / max(total_in, 1)
    error = dev.get("error")
    detail = {"files": host["files"], "device": dev}
    if not error:
        # the device corpus rides substream_bins=CORPUS_B (lane-parallel
        # coder resets), a format trade-off against the host's one stream
        dev["ratio_delta_vs_host_pts"] = round(dev["ratio_pct"] - host_ratio, 2)
        log("device headline:", dev["compress_mb_s"], "MB/s,",
            "ratio delta vs host: %+.2f pts" % dev["ratio_delta_vs_host_pts"])
    failures = host["failures"] + (dev.get("roundtrip_failures") or 0)
    use_dev = (not error and dev["roundtrip_failures"] == 0
               and dev["compress_mb_s"] > host_mb_s)
    ratio = dev["ratio_pct"] if use_dev else host_ratio
    value = dev["compress_mb_s"] if use_dev else round(host_mb_s, 3)
    failed = bool(failures or error)
    saving = 100.0 - ratio
    return {
        "metric": "recode MB/s per chip; compression ratio %; bit-exact "
                  "roundtrip pass rate",
        "value": 0.0 if failed else value,
        "unit": "MB/s",
        # target band: >=5% size reduction; 1.0 == on target
        "vs_baseline": 0.0 if failed else round(saving / 5.0, 3),
        "path": "device" if use_dev else "host",
        "ratio_pct": round(ratio, 2),
        "space_saving_pct": round(saving, 2),
        "host_compress_mb_s": round(host_mb_s, 3),
        "device_pass_mb_s": dev.get("pass_mb_s"),
        "decompress_mb_s": round(total_in / 1e6
                                 / max(host["decompress_s"], 1e-9), 3),
        "roundtrip_failures": failures,
        "device_error": error,
        "device_name": dev.get("device_name"),
        "power_limit": dev.get("power_limit"),
        "native": True,
        "detail": detail,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m avrecode_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the device section (default: the "
                         "card; 'cpu' runs the plain torch coder)")
    ap.add_argument("--device-corpus", nargs="+", metavar="PATH",
                    help="run only the device section on these files")
    args = ap.parse_args(argv)
    if args.device_corpus:
        res = device_corpus(args.device_corpus, device=args.device)
        print(json.dumps(res), flush=True)
        return 1 if res["roundtrip_failures"] else 0
    dev = resolve_device(args.device)
    ensure_native()
    paths = ensure_corpus()
    result = headline(host_corpus(paths), bench_device(paths, dev))
    print(json.dumps(result), flush=True)
    return 1 if result["roundtrip_failures"] or result["device_error"] else 0


if __name__ == "__main__":
    sys.exit(main())
