"""The broadcast configuration (configs/broadcast_1080i.json): 1080i MBAFF
recordings of half-second GOPs on the lane main path, at camera_1080p's
settings.

Its pool is four closed GOPs, each one unit with an MBAFF SPS, taken by the
program's native extractor, at least 90% of each GOP's bins in field pairs.
On the CPU, data/bc_mbaff.264 (three small MBAFF GOPs, made by
`AVT_COMB=1 tools/genvideo bc_mbaff.264 176 160 18 30 6 2 26 11 1
interlaced=1:tff=1:repeat-headers=1`) stands in for the pool: the
reference's splice of its units' containers equals the reference over the
whole stream, a sound run is `correct` and the control is not, and the
cell's readers read the traced run.  test_control_on_card runs the
control at the cell's own size (python -m pytest -m cuda benchmark/tests)."""

import json

import pytest

from conftest import BENCH, DATA, make_base, spec_of

from benchmark.harness import drive, inputs
from benchmark.harness.spec import Spec
from benchmark.reference import expected

CELL = "broadcast_1080i.batch"
TINY = "tiny_broadcast.batch"
CLIP = "bc_mbaff.264"
CONTROL = {"substream_bins": 8192}
READERS = {"mbaff_parse_ns_per_bin.broadcast_1080i": "gop_parse_s",
           "mbaff_model_ns_per_bin.broadcast_1080i": "gop_model_s"}
POOL = ["bc_gop1.264", "bc_gop2.264", "bc_gop3.264", "bc_gop4.264"]


def _config():
    return json.loads((BENCH / "configs" / "broadcast_1080i.json").read_text())


def _pool():
    config = _config()
    return {name: (BENCH / config["pool"]["dir"] / name).read_bytes()
            for name in config["pool"]["files"]}


def _sps(unit):
    from avrecode_tpu_torch.h264.params import parse_sps

    nal = unit.split(b"\x00\x00\x01")[1]  # a unit starts at its SPS
    assert nal[0] & 0x1F == 7
    return parse_sps(nal)


def _units():
    return inputs.annexb_units((DATA / CLIP).read_bytes())


def test_the_configuration_is_the_camera_settings_on_interlaced_gops():
    spec = Spec()
    config, camera = _config(), spec.config("camera_1080p")
    assert config["settings"] == camera["settings"]
    assert config["job"] == {"kind": "recordings",
                             "recording_gops": [[48, 96], [64, 80]]}
    assert config["reduced"] == ["recording_gops"]
    assert set(config["pool"]["made_by"]) == set(config["pool"]["files"])
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "broadcast_1080i", "batch", 1)


@pytest.mark.parametrize("name", POOL)
def test_each_pool_file_is_one_mbaff_unit(name):
    data = _pool()[name]
    (unit,) = inputs.annexb_units(data)
    sps = _sps(unit)
    assert sps.frame_mbs_only_flag == 0
    assert sps.mb_adaptive_frame_field_flag == 1
    # 7-10 Mb/s over the half second of a 15-frame GOP at 30 frames/s
    assert 7e6 <= 8 * len(data) / 0.5 <= 10e6


def test_the_pool_is_under_the_inputs_limit():
    assert sum(len(d) for d in _pool().values()) < 5 * 2 ** 20


@pytest.mark.parametrize("name", POOL)
def test_each_gop_is_field_pairs_nearly_throughout(name):
    """The lane main path's native extraction of each pool GOP: at least
    90% of its bins in MBAFF pairs decoded as fields, the configuration's
    field share."""
    from avrecode_tpu_torch import spans
    from avrecode_tpu_torch.host import native

    assert native.available()
    stats = {}
    with spans.call("extract", stats):
        traces = native.extract_lanes(_pool()[name])[3]
    bins = sum(len(t) for t in traces if len(t))
    assert bins > 0
    assert stats["gop_field_bins"] / bins >= 0.9


def test_the_pool_takes_the_programs_native_route():
    """As the camera pool (test_reference_splice.py): every GOP is taken by
    the native extractor and has traces for the lane coder, so the frozen
    reference is never checked against a copy of itself."""
    from avrecode_tpu_torch.host import native
    from avrecode_tpu_torch.parallel import pipeline

    assert native.available()
    for name, data in _pool().items():
        for unit in inputs.annexb_units(data):
            *_, traces, stats = pipeline.extract_traces(
                unit, scope="gop", want_slots=False)
            assert stats["native"] and traces, name


def test_the_small_clip_is_three_mbaff_units():
    units = _units()
    assert len(units) == 3
    for unit in units:
        assert _sps(unit).mb_adaptive_frame_field_flag == 1


@pytest.mark.parametrize("seq", [[0, 1, 2], [2, 0, 1, 1]])
def test_splice_equals_the_reference_over_the_whole_stream(seq):
    units = _units()
    B = _config()["settings"]["substream_bins"]
    blobs = [expected.compress(u, B) for u in units]
    whole = b"".join(units[i] for i in seq)
    assert expected.splice([blobs[i] for i in seq]) == \
        expected.compress(whole, B)


def test_sound_run_is_correct_and_the_control_is_not(tmp_path):
    """The small clip's units as one recording, a job a corpus call, at the
    configuration's settings: the sound run is `correct`; the control,
    traced, mismatches every recording, and the cell's readers read its
    counters."""
    base = make_base(
        tmp_path, [TINY],
        {"tiny_broadcast": (DATA, [CLIP],
                            {"kind": "recordings", "recording_gops": [[3]]},
                            1)})
    spec = spec_of(base)
    sound, checks = drive.run_cell(spec, TINY, 17, 0.05, False, device="cpu")
    assert drive.correct(checks), checks
    rec, checks = drive.run_cell(spec, TINY, 17, 0.05, True, device="cpu",
                                 settings=CONTROL)
    assert not drive.correct(checks)
    assert checks["mismatched_files"]["value"] == \
        checks["files_checked"]["value"] >= 1
    st = rec["stats"]
    assert 0 < st["gop_field_bins"] < st["bins"]
    for name, key in READERS.items():
        reader = spec.reader(name)
        assert reader.read(rec) == pytest.approx(1e9 * st[key] / st["bins"])
        assert reader.read(rec) > 0
        assert reader.read(sound) is None, name  # untraced


def _record(stats, traced=True):
    rec = {"units": [{"t0": 0.0, "t1": 6.0, "bytes": 73_000_000,
                      "files": 2, "error": None}], "stats": stats}
    if traced:
        rec["trace"] = {"busy_s": 0.1, "trace_window_s": 6.0}
    return rec


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_the_counters_ratio(name):
    reader = Spec().reader(name)
    stats = {"gop_field_bins": 19 * 10 ** 7, "gop_parse_s": 12.5,
             "gop_model_s": 10.5, "bins": 2 * 10 ** 8}
    assert reader.read(_record(stats)) == pytest.approx(
        1e9 * stats[READERS[name]] / 2e8)
    assert reader.read(_record(stats, traced=False)) is None
    # progressive input: no field pair
    assert reader.read(_record(dict(stats, gop_field_bins=0))) is None
    # the parent's stats: no such counter
    parent = {k: v for k, v in stats.items() if k != "gop_field_bins"}
    assert reader.read(_record(parent)) is None


def test_readers_are_declared_for_the_broadcast_cell():
    spec = Spec()
    for name in READERS:
        (m,) = [m for m in spec.data["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL]
        assert (m["layer"], m["moves"], m["unit"], m["better"]) == (
            "host extract", "compress_mb_s", "ns/bin", "lower")
        reader = spec.reader(name)
        assert (reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["moves"], m["source"])


@pytest.mark.parametrize("name,camera", [
    ("device_idle_pct.broadcast_1080i", "device_idle_pct"),
    ("lane_kernel_roofline.broadcast_1080i", "lane_kernel_roofline.batch")])
def test_device_readers_read_as_the_camera_cells(name, camera):
    """The card's idle share and the lane kernel's roofline share, declared
    for the broadcast cell as the camera cells' are for theirs, and read
    from a run's record the same way."""
    spec = Spec()
    (m,) = [m for m in spec.data["per_layer"] if m["name"] == name]
    (c,) = [m for m in spec.data["per_layer"] if m["name"] == camera]
    assert m["workloads"] == [CELL]
    assert {k: v for k, v in m.items() if k not in ("name", "workloads")} \
        == {k: v for k, v in c.items() if k not in ("name", "workloads")}
    rec = _record({"bins": 2 * 10 ** 8})
    rec["trace"]["ops"] = {"lane_encode_streams_idx_kernel": (4, 0.05)}
    rec["groups"] = [{"rows": 8192, "Bp": 16384, "bins": 10 ** 8,
                      "stored": 6 * 10 ** 6, "index": True}] * 2
    value = spec.reader(name).read(rec)
    assert value is not None and value == spec.reader(camera).read(rec)
    assert spec.reader(name).read({"units": [], "stats": {}}) is None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4_300_000_001, 4_300_000_002,
                                  4_300_000_003])
def test_control_on_card(card, seed):
    spec = Spec()
    rec, checks = drive.run_cell(spec, CELL, seed, spec.data["run_seconds"],
                                 False, device=card, settings=CONTROL)
    print(f"control {CELL} seed {seed}: {checks}")
    assert not drive.correct(checks)
    assert checks["mismatched_files"]["value"] == \
        checks["files_checked"]["value"] >= 1
