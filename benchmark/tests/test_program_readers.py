"""The readers of the program's extraction stats: None in an untraced run
and where the program has no such stats (a tree before them, a job of no
native extraction), and each its number on a synthetic record."""

import pytest

from benchmark.harness.spec import Spec

STATS = {"gop_jobs": 72, "gop_parse_s": 3.5, "gop_model_s": 2.5,
         "gop_job_s": 7.0, "gop_cpu_s": 6.3, "gop_pool_s": 8.0,
         "extract_walk_s": 0.2, "extract_stitch_s": 0.1,
         "extract_py_s": 0.3, "extract_release_s": 0.4,
         "dispatches": 2, "bins": 10**8, "pack_s": 0.1, "copy_s": 0.05}
MB = 35.0  # the record's input, finished
WANT = {
    "gop_parse_s_per_mb.batch": 3.5 / MB,
    "gop_model_s_per_mb.batch": 2.5 / MB,
    "extract_serial_s_per_mb.batch": 1.0 / MB,
    "gop_pool_idle_pct.batch": 12.5,
    "gop_cpu_pct.batch": 90.0,
}


def _record(stats, traced=True):
    rec = {"units": [{"t0": 0.0, "t1": 6.0, "bytes": int(MB * 1e6),
                      "files": 2, "error": None}], "stats": stats}
    if traced:
        rec["trace"] = {"busy_s": 0.1, "trace_window_s": 6.0}
    return rec


@pytest.mark.parametrize("name", sorted(WANT))
def test_program_reader(name):
    reader = Spec().reader(name)
    assert reader.read(_record(STATS)) == pytest.approx(WANT[name])
    assert reader.read(_record(STATS, traced=False)) is None
    # the parent's stats: no extraction counters
    parent = {k: STATS[k] for k in ("dispatches", "bins", "pack_s", "copy_s")}
    assert reader.read(_record(parent)) is None
    # a window whose files took no native GOP job
    idle = dict(STATS, **{k: 0 for k in STATS if k.startswith("gop_")})
    assert reader.read(_record(idle)) is None


def test_program_readers_are_declared():
    spec = Spec()
    for name in WANT:
        (m,) = [m for m in spec.data["per_layer"] if m["name"] == name]
        assert m["layer"] == "host extract" and m["moves"] == "compress_mb_s"
        assert m["workloads"] == ["camera_1080p.batch"]
        reader = spec.reader(name)
        assert (reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["moves"], m["source"])
