"""The port's command line against the JAX package's, on the same files:
`python -m avrecode_tpu_torch` and `python -m avrecode_tpu` write the same
bytes for every command and option, print the same messages, and exit with
the same codes."""

import concurrent.futures
import csv
import os
import re
import shutil
import subprocess
import sys

import pytest

import avrecode_tpu_torch
from avrecode_tpu_torch.host import native

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "data")
PACKAGES = ("avrecode_tpu_torch", "avrecode_tpu")


def _cli(package, *argv):
    return subprocess.run([sys.executable, "-m", package, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)


def _timeless(text):
    """A message without its times and rates, which differ run to run."""
    return re.sub(r"[0-9.]+(s| MB/s)", r"T\1", text)


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


def _both(fn):
    """fn(package) for both packages, side by side."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return list(pool.map(fn, PACKAGES))


# mbaff_b.mkv has 4 GOPs (2 and 7 hosts: full and empty shards); the Python
# codec runs on the smaller clip
@pytest.mark.parametrize("clip, opts", [
    ("mbaff_b.mkv", ()), ("mbaff_b.mkv", ("--hosts", "2")),
    ("mbaff_b.mkv", ("--hosts", "7")), ("mbaff_b.mkv", ("--stream",)),
    ("rt_ctr.mkv", ("--python",)), ("mbaff_b.mkv", ("--scope", "slice")),
    ("rt_ctr.mkv", ("--scope", "stream", "--threads", "1")),
    ("rt_ctr.mkv", ("--hosts", "2", "--scope", "slice")),
    ("rt_ctr.ts", ("--stream", "--threads", "1")),
], ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_compress_decompress_same_bytes(clip, opts, tmp_path):
    src = os.path.join(DATA, clip)
    with open(src, "rb") as f:
        data = f.read()

    def run(pkg):
        avtr, out = tmp_path / f"{pkg}.avtr", tmp_path / f"{pkg}.out"
        res = _cli(pkg, *opts, "compress", src, str(avtr))
        assert res.returncode == 0, res.stderr
        msg = res.stderr.replace(str(avtr), "OUT")
        res = _cli(pkg, *opts, "decompress", str(avtr), str(out))
        assert res.returncode == 0, res.stderr
        assert out.read_bytes() == data
        return (avtr.read_bytes(),
                _timeless(msg + res.stderr.replace(str(avtr), "IN")))

    (port_blob, port_msg), (ref_blob, ref_msg) = _both(run)
    assert port_blob == ref_blob
    assert port_msg == ref_msg
    assert "compressed" in port_msg and "decompressed" in port_msg


def test_default_output_names(tmp_path):
    src = tmp_path / "clip.mkv"
    shutil.copy(os.path.join(DATA, "rt_ctr.mkv"), src)
    assert _cli("avrecode_tpu_torch", "compress", str(src)).returncode == 0
    assert _cli("avrecode_tpu_torch", "decompress",
                str(src) + ".avtr").returncode == 0
    assert (tmp_path / "clip.mkv.out").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("opts", [(), ("--hosts", "2"), ("--scope", "slice")],
                         ids=" ".join)
def test_roundtrip_exits_zero(opts):
    src = os.path.join(DATA, "rt_ctr.mkv")
    results = _both(lambda pkg: _cli(pkg, *opts, "roundtrip", src))
    for res in results:
        assert res.returncode == 0, res.stderr
        assert res.stderr.startswith("roundtrip OK: compression ratio: ")
    assert _timeless(results[0].stderr) == _timeless(results[1].stderr)


def test_corpus_run_same_metrics_and_outputs(tmp_path):
    """`test <dir>`: the same metrics.csv columns, sizes and ratios, the
    same decompressed files, exit code 0."""
    names = ["rt_ctr.mkv", "rt_ctr.ts", "mbaff_b.mkv"]

    def run(pkg):
        d = tmp_path / pkg
        d.mkdir()
        for n in names:
            shutil.copy(os.path.join(DATA, n), d / n)
        (d / "notes.txt").write_bytes(b"not a video\n" * 9)
        res = _cli(pkg, "test", str(d))
        assert res.returncode == 0, res.stderr
        assert res.stderr.splitlines()[-1] == "4 files, 0 failures"
        with open(d / "output" / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        for n in names + ["notes.txt"]:
            assert (d / "output" / n).read_bytes() == (d / n).read_bytes()
        return rows

    tables = _both(run)
    port, ref = tables
    assert [list(r) for r in port] == [list(r) for r in ref]
    assert list(port[0])[:4] == ["File", "Initial size (MB)",
                                 "Compressed size (MB)", "Compression rate (%)"]
    timeless = [c for c in port[0] if "time" not in c and "speed" not in c]
    assert len(timeless) == 6
    for a, b in zip(port, ref):
        assert [a[c] for c in timeless] == [b[c] for c in timeless]
        assert a["Roundtrip"] == "OK"


@pytest.mark.parametrize("argv", [
    ("--frobnicate", "compress", "x"), ("frobnicate", "x"), ("compress",), (),
], ids=" ".join)
def test_bad_command_line_exits_two(argv):
    results = _both(lambda pkg: _cli(pkg, *argv))
    assert [r.returncode for r in results] == [2, 2]
    if argv and len(argv) > 1:
        assert results[0].stderr == results[1].stderr
        assert results[0].stderr.startswith("unknown ")
    else:  # the usage text, each package's own
        assert "python -m avrecode_tpu_torch compress" in results[0].stderr


def test_package_level_compress_and_decompress():
    """avrecode_tpu_torch.compress / decompress, as the JAX package's."""
    import avrecode_tpu

    with open(os.path.join(DATA, "mbaff_b.mkv"), "rb") as f:
        data = f.read()
    for kw in ({}, {"scope": "slice"}, {"scope": "gop", "threads": 1}):
        blob = avrecode_tpu_torch.compress(data, **kw)
        assert blob == avrecode_tpu.compress(data, **kw)
        assert avrecode_tpu_torch.decompress(blob) == data
        assert avrecode_tpu_torch.decompress(blob, threads=1) == data
