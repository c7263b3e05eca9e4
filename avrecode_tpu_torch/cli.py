"""Command-line interface of the port; the commands, options, messages,
exit codes and metrics.csv columns of the JAX package's avrecode_tpu/cli.py.

  python -m avrecode_tpu_torch compress   <in> [out]  (default out: <in>.avtr)
  python -m avrecode_tpu_torch decompress <in> [out]
  python -m avrecode_tpu_torch roundtrip  <in>
  python -m avrecode_tpu_torch test      <dir>        corpus run -> metrics.csv

Options (before the command):
  --scope stream|gop|slice   model scope (default gop: parallel-decodable)
  --threads N                0=auto, 1=serial (gop scope parallelism)
  --python                   force the Python reference implementation
  --hosts N                  shard each file over N simulated hosts
                             (GOP-range fragments + stitch, gop scope)
  --stream                   file-to-file streaming IO (O(GOP-window) memory)

The command line is host code (the native library, the Python codec,
parallel/multihost.py for --hosts, utils/streamio.py for --stream), as it
is in the JAX package; the device paths are the Python entry points of
parallel/pipeline.py.

The corpus run records, per file, sizes, ratios and timings into
<dir>/output/metrics.csv and writes decompressed outputs for inspection.
"""

import csv
import os
import sys
import time

from .codec import compress as py_compress, decompress as py_decompress

OPTS = {"scope": "gop", "threads": 0, "python": False, "hosts": 0,
        "stream": False}


def compress(data, verbose=False):
    if not OPTS["python"]:
        from .host import native

        if native.available():
            if OPTS["hosts"] > 1 and OPTS["scope"] == "gop":
                # multi-host mode: each "host" recodes its GOP shard, the
                # fragments stitch into one container (parallel/multihost.py;
                # run single-machine here, the same code path a real
                # torch.distributed deployment drives per rank)
                from .parallel.multihost import compress_sharded, stitch

                return stitch(
                    compress_sharded(data, i, OPTS["hosts"],
                                     threads=OPTS["threads"])
                    for i in range(OPTS["hosts"])
                )
            return native.compress(data, OPTS["scope"], OPTS["threads"])
    return py_compress(data, verbose=verbose, scope=OPTS["scope"])


def decompress(blob):
    if not OPTS["python"]:
        from .host import native

        if native.available():
            if OPTS["hosts"] > 1:
                # multi-host decode: each "host" decompresses its GOP-group
                # range of the container, outputs concatenate (the decode
                # mirror of compress_sharded)
                from .parallel.multihost import (decompress_sharded,
                                                 stitch_decompressed)

                return stitch_decompressed(
                    decompress_sharded(blob, i, OPTS["hosts"],
                                       threads=OPTS["threads"])
                    for i in range(OPTS["hosts"])
                )
            return native.decompress(blob, OPTS["threads"])
    return py_decompress(blob)


def _human(n):
    return f"{n / 1e6:.2f}MB"


def _safe(fn, *a):
    try:
        return fn(*a)
    except Exception as e:
        return e


def cmd_compress(argv):
    inp = argv[0]
    out = argv[1] if len(argv) > 1 else inp + ".avtr"
    if OPTS["stream"]:
        # O(GOP-window) memory: mmap'd input, fragments flushed as produced
        from .utils.streamio import stream_compress

        t0 = time.time()
        stream_compress(inp, out, threads=OPTS["threads"])
        dt = time.time() - t0
        n_in, n_out = os.path.getsize(inp), os.path.getsize(out)
        print(
            f"compressed {inp} (streaming): {n_in} -> {n_out} bytes "
            f"({100.0 * n_out / max(1, n_in):.2f}%) in {dt:.2f}s",
            file=sys.stderr,
        )
        return 0
    data = open(inp, "rb").read()
    t0 = time.time()
    blob = compress(data, verbose=True)
    dt = time.time() - t0
    open(out, "wb").write(blob)
    print(
        f"compressed {inp}: {len(data)} -> {len(blob)} bytes "
        f"({100.0 * len(blob) / max(1, len(data)):.2f}%) in {dt:.2f}s "
        f"({len(data) / 1e6 / max(dt, 1e-9):.2f} MB/s)",
        file=sys.stderr,
    )
    return 0


def cmd_decompress(argv):
    inp = argv[0]
    out = argv[1] if len(argv) > 1 else inp.removesuffix(".avtr") + ".out"
    if OPTS["stream"]:
        from .utils.streamio import stream_decompress

        t0 = time.time()
        stream_decompress(inp, out, threads=OPTS["threads"])
        dt = time.time() - t0
        print(
            f"decompressed {inp} (streaming): {os.path.getsize(inp)} -> "
            f"{os.path.getsize(out)} bytes in {dt:.2f}s",
            file=sys.stderr,
        )
        return 0
    blob = open(inp, "rb").read()
    t0 = time.time()
    data = decompress(blob)
    dt = time.time() - t0
    open(out, "wb").write(data)
    print(
        f"decompressed {inp}: {len(blob)} -> {len(data)} bytes in {dt:.2f}s",
        file=sys.stderr,
    )
    return 0


def cmd_roundtrip(argv):
    inp = argv[0]
    data = open(inp, "rb").read()
    t0 = time.time()
    comp = compress(data)
    t1 = time.time()
    dec = decompress(comp)
    t2 = time.time()
    ok = dec == data
    ratio = 100.0 * len(comp) / max(1, len(data))
    print(
        f"{'roundtrip OK' if ok else 'ROUNDTRIP MISMATCH'}: "
        f"compression ratio: {ratio:.2f}% "
        f"(compress {t1 - t0:.2f}s, decompress {t2 - t1:.2f}s)",
        file=sys.stderr,
    )
    return 0 if ok else 1


def cmd_test(argv):
    """Corpus run: roundtrip every file in a directory,
    write metrics.csv + decompressed outputs to <dir>/output/.  Files are
    processed concurrently (the native library releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    d = argv[0]
    outdir = os.path.join(d, "output")
    os.makedirs(outdir, exist_ok=True)
    rows = []
    failures = 0
    files = sorted(
        f
        for f in os.listdir(d)
        if os.path.isfile(os.path.join(d, f)) and not f.startswith(".")
    )

    def run_one(name):
        path = os.path.join(d, name)
        data = open(path, "rb").read()
        t0 = time.time()
        comp = compress(data)
        t1 = time.time()
        dec = decompress(comp)
        t2 = time.time()
        return data, comp, dec, t1 - t0, t2 - t1

    jobs = min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        results = list(pool.map(lambda n: _safe(run_one, n), files))

    for name, res in zip(files, results):
        if isinstance(res, Exception):  # corpus keeps going on failure
            print(f"{name}: EXCEPTION {res!r}", file=sys.stderr)
            failures += 1
            continue
        data, comp, dec, ctime, dtime = res
        ok = dec == data
        if not ok:
            failures += 1
        open(os.path.join(outdir, name), "wb").write(dec)
        ratio = 100.0 * len(comp) / max(1, len(data))
        rows.append(
            {
                "File": name,
                "Initial size (MB)": f"{len(data) / 1e6:.3f}",
                "Compressed size (MB)": f"{len(comp) / 1e6:.3f}",
                "Compression rate (%)": f"{ratio:.2f}",
                "Space saving (%)": f"{100 - ratio:.2f}",
                "Total time (ms)": f"{(ctime + dtime) * 1000:.0f}",
                "Compression time (ms)": f"{ctime * 1000:.0f}",
                "Decompression time (ms)": f"{dtime * 1000:.0f}",
                "Compression speed (MB/s)": f"{len(data) / 1e6 / max(ctime, 1e-9):.2f}",
                "Decompression speed (MB/s)": f"{len(data) / 1e6 / max(dtime, 1e-9):.2f}",
                "Roundtrip": "OK" if ok else "FAIL",
            }
        )
        print(f"{name}: {'OK' if ok else 'FAIL'} ratio {ratio:.2f}%", file=sys.stderr)
    if rows:
        with open(os.path.join(outdir, "metrics.csv"), "w", newline="") as f:
            wcsv = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            wcsv.writeheader()
            wcsv.writerows(rows)
    print(f"{len(rows)} files, {failures} failures", file=sys.stderr)
    return 1 if failures else 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    while argv and argv[0].startswith("--"):
        opt = argv.pop(0)
        if opt == "--scope":
            OPTS["scope"] = argv.pop(0)
        elif opt == "--threads":
            OPTS["threads"] = int(argv.pop(0))
        elif opt == "--python":
            OPTS["python"] = True
        elif opt == "--hosts":
            OPTS["hosts"] = int(argv.pop(0))
        elif opt == "--stream":
            OPTS["stream"] = True
        else:
            print(f"unknown option {opt}", file=sys.stderr)
            return 2
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    handler = {
        "compress": cmd_compress,
        "decompress": cmd_decompress,
        "roundtrip": cmd_roundtrip,
        "test": cmd_test,
    }.get(cmd)
    if handler is None:
        print(f"unknown command {cmd}", file=sys.stderr)
        return 2
    return handler(rest)


if __name__ == "__main__":
    sys.exit(main())
