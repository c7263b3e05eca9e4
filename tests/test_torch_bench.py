"""The port's corpus driver (avrecode_tpu_torch/bench.py) against the JAX
package's bench.py and device_compress_corpus, on the CPU: the same corpus
tables; containers byte-identical to the JAX corpus pipeline's, and the
per-file and total fields they give; a roundtrip failure in either section,
a device section that raises, prints no line or runs out of time, and a
missing card each end the run with a non-zero exit and the reason."""

import json
import os
import subprocess
import sys

import pytest
import torch

import bench as jax_bench
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import bench
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.parallel import pipeline as tpipe

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data")
PATHS = [os.path.join(DATA, n)
         for n in ("rt_ctr.mkv", "mbaff_b.mkv", "cavlc_ipp.mkv", "sep.264")]
SMALL_B = 4096  # the plain loop's cost follows B: the failure cases use less


@pytest.fixture(scope="module")
def corpus_run():
    """device_corpus on PATHS at CORPUS_B on the CPU, with every pass's
    containers as device_compress_corpus returned them."""
    passes = []
    real = tpipe.device_compress_corpus

    def spy(*args, **kwargs):
        passes.append(real(*args, **kwargs))
        return passes[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "device_compress_corpus", spy)
        res = bench.device_corpus(PATHS, device="cpu")
    return res, passes


def _corrupt_decompress(monkeypatch, name):
    """native.decompress returns wrong bytes for the file `name`."""
    target = open(os.path.join(DATA, name), "rb").read()
    real = native.decompress

    def wrong(blob, threads=1):
        out = real(blob, threads)
        return out[:-1] + bytes([out[-1] ^ 1]) if out == target else out

    monkeypatch.setattr(native, "decompress", wrong)


def test_corpus_tables_equal_bench_py():
    assert bench.CORPUS == jax_bench.CORPUS
    assert bench.CORPUS_ENV == jax_bench.CORPUS_ENV
    assert bench.CONFORMANCE == jax_bench.CONFORMANCE
    assert bench.CORPUS_B == jax_bench.CORPUS_B


def test_device_corpus_matches_jax_corpus(corpus_run):
    res, passes = corpus_run
    ref = jpipe.device_compress_corpus(PATHS, scope="gop",
                                       substream_bins=bench.CORPUS_B)
    assert len(passes) == bench.PASSES
    for comps in passes:
        assert comps == ref
    datas = [open(p, "rb").read() for p in PATHS]
    assert res["files"] == [
        {"file": os.path.basename(p), "mb": round(len(d) / 1e6, 3),
         "ratio_pct": round(100 * len(c) / len(d), 2), "roundtrip": "OK"}
        for p, d, c in zip(PATHS, datas, ref)]
    assert res["total_in"] == sum(map(len, datas))
    assert res["total_out"] == sum(map(len, ref))
    assert res["ratio_pct"] == round(100 * res["total_out"] / res["total_in"], 2)
    assert res["roundtrip_failures"] == 0
    assert res["kernel"] == "torch-plain-lane" and res["backend"] == "cpu"
    assert res["device_name"] is None and res["power_limit"] is None
    assert res["dispatches"] == 1 and res["overflows"] == [0] * bench.PASSES
    assert res["corpus_bins"] > 0
    assert len(res["pass_s"]) == len(res["pass_mb_s"]) == bench.PASSES
    assert len(res["pack_s"]) == len(res["copy_s"]) == bench.PASSES
    assert all(s >= 0 for s in res["pack_s"] + res["copy_s"])
    split = res["stage_split_480p"]
    assert split["file"] == os.path.basename(max(PATHS, key=os.path.getsize))
    assert split["bins"] > 0


def test_device_roundtrip_failure_is_counted(monkeypatch, capsys):
    _corrupt_decompress(monkeypatch, "sep.264")
    res = bench.device_corpus(PATHS[::3], device="cpu",
                              substream_bins=SMALL_B)
    assert [f["roundtrip"] for f in res["files"]] == ["OK", "FAIL"]
    assert res["roundtrip_failures"] == 1
    monkeypatch.undo()  # the host section decodes correctly
    monkeypatch.setattr(bench, "ensure_corpus", lambda: PATHS[::3])
    monkeypatch.setattr(bench, "bench_device", lambda paths, dev: res)
    assert bench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["roundtrip_failures"] == 1 and line["device_error"] is None
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0


def test_a_pass_that_differs_fails_the_device_section(monkeypatch):
    """Every pass's containers are held to the last pass's: a first pass
    with one wrong byte raises, though the last pass, the one
    roundtripped, is right (the device section then exits non-zero)."""
    real = tpipe.device_compress_corpus
    first, calls = {}, []

    def flaky(*args, stats=None, **kwargs):
        if not first:  # one real pass, then its containers again
            first["comps"] = real(*args, stats=stats, **kwargs)
            first["stats"] = dict(stats)
        stats.update(first["stats"])
        comps = list(first["comps"])
        calls.append(len(comps))
        if len(calls) == 1:
            comps[0] = comps[0][:-1] + bytes([comps[0][-1] ^ 1])
        return comps

    monkeypatch.setattr(tpipe, "device_compress_corpus", flaky)
    with pytest.raises(RuntimeError,
                       match=r"^pass 1 of 3: containers differ from the "
                             r"last pass's$"):
        bench.device_corpus(PATHS[3:], device="cpu", substream_bins=SMALL_B)
    assert calls == [1] * bench.PASSES


def test_host_roundtrip_failure_zeroes_the_headline(monkeypatch, capsys,
                                                    corpus_run):
    """One FAIL in the host section zeroes the headline, whatever the clean
    device section gives."""
    _corrupt_decompress(monkeypatch, "sep.264")
    monkeypatch.setattr(bench, "ensure_corpus", lambda: PATHS)
    monkeypatch.setattr(bench, "bench_device",
                        lambda paths, dev: dict(corpus_run[0]))
    assert bench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [f["roundtrip"] for f in line["detail"]["files"]] == [
        "OK", "OK", "OK", "FAIL"]
    assert line["roundtrip_failures"] == 1 and line["device_error"] is None
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0


def test_clean_run_takes_the_fastest_path(monkeypatch, capsys, corpus_run):
    res = dict(corpus_run[0])
    monkeypatch.setattr(bench, "ensure_corpus", lambda: PATHS)
    monkeypatch.setattr(bench, "bench_device", lambda paths, dev: res)
    assert bench.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["roundtrip_failures"] == 0 and line["device_error"] is None
    # the plain torch coder is slower than the native host path
    assert line["path"] == "host"
    assert line["value"] == line["host_compress_mb_s"] > 0
    assert line["device_pass_mb_s"] == res["pass_mb_s"]
    assert "ratio_delta_vs_host_pts" in line["detail"]["device"]


def _completed(rc, out, err):
    return lambda cmd, **kw: subprocess.CompletedProcess(cmd, rc, out, err)


def _timeout(cmd, **kw):
    raise subprocess.TimeoutExpired(cmd, kw["timeout"])


@pytest.mark.parametrize("run, says", [
    (_completed(1, "", "Traceback ...\nRuntimeError: kernel failed\n"),
     "device section raised (exit 1): RuntimeError: kernel failed"),
    (_completed(0, "no result here\n", ""),
     "device section printed no result line"),
    (_timeout, "device section timed out: past its 2400 s budget"),
], ids=["raises", "no_line", "timeout"])
def test_device_section_failure_exits_nonzero(monkeypatch, capsys, run, says):
    monkeypatch.setattr(bench, "ensure_corpus", lambda: PATHS[3:])
    monkeypatch.setattr(bench.subprocess, "run", run)
    assert bench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device_error"].startswith(says)
    assert line["detail"]["device"] == {"error": line["device_error"]}
    assert line["value"] == 0.0 and line["roundtrip_failures"] == 0


def test_entry_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "ensure_corpus", lambda: PATHS)
    for argv in ([], ["--device", "cuda"], ["--device-corpus", PATHS[0]]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.device_corpus(PATHS)


def test_module_entry_point_runs_the_inner_protocol():
    """python3 -m avrecode_tpu_torch.bench --device-corpus, the device
    section as main() and chip_smoke.py start it: one result line."""
    cmd = [sys.executable, "-m", "avrecode_tpu_torch.bench", "--device",
           "cpu", "--device-corpus", PATHS[3]]
    r = subprocess.run(cmd, cwd=bench.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    (out,) = r.stdout.splitlines()
    res = json.loads(out)
    assert res["kernel"] == "torch-plain-lane" and res["roundtrip_failures"] == 0
    assert [f["roundtrip"] for f in res["files"]] == ["OK"]
    assert "device corpus pass 3" in r.stderr


@pytest.mark.parametrize("generator", ["unbuildable", "failing"])
def test_ensure_corpus_names_missing_files(monkeypatch, tmp_path, generator):
    gen = tmp_path / "genvideo"
    if generator == "failing":
        gen.write_text("#!/bin/sh\necho no libx264 >&2\nexit 3\n")
        gen.chmod(0o755)
    monkeypatch.setattr(bench, "DATA", str(tmp_path / "data"))
    monkeypatch.setattr(bench, "GEN", str(gen))
    with pytest.raises(RuntimeError) as e:
        bench.ensure_corpus()
    msg = str(e.value)
    assert "20 files missing" in msg
    for name, *_ in bench.CORPUS + bench.CONFORMANCE:
        assert name in msg
    assert ("building tools/genvideo failed" if generator == "unbuildable"
            else "tools/genvideo exited 3: no libx264") in msg
    assert os.listdir(tmp_path / "data") == []  # no partial clip is left


def test_ensure_corpus_uses_files_present(monkeypatch, tmp_path):
    """Present files are taken as they are: the generator is not needed."""
    names = [name for name, *_ in bench.CORPUS + bench.CONFORMANCE]
    for name in names:
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr(bench, "DATA", str(tmp_path))
    monkeypatch.setattr(bench, "GEN", str(tmp_path / "absent"))
    assert bench.ensure_corpus() == [str(tmp_path / n) for n in names]
    os.unlink(tmp_path / "spsi.264")
    with pytest.raises(RuntimeError, match=r"1 files missing: spsi\.264 "
                                           r"\(pinned conformance streams"):
        bench.ensure_corpus()


def test_conformance_streams_are_pinned():
    """The five streams are tracked files, not made at run time."""
    ignore = open(os.path.join(bench.ROOT, ".gitignore")).read().split()
    for name, _ in bench.CONFORMANCE:
        assert f"!data/{name}" in ignore
        assert os.path.getsize(os.path.join(DATA, name)) > 0
